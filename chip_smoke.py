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
2. build    compile the four CUDA kernels from ``csrc/``, one ``nvcc`` each, at
            once; print each library's ``ptxas -v`` report and its count of
            tensor-core instructions (``cuobjdump -sass``), which must not be
            0 for conv5, the ViT attention and the int8 conv; the warpgroup
            kernels (the bf16 ViT attention, the int8 conv, conv5's bf16
            variant) must hold HGMMA / IGMMA, conv5's bf16 variant no HMMA,
            and each its ``ptxas -v`` lines (printed) no spill and no note
            that ptxas serialised its wgmma;
3. kernels  slot attention against its plain PyTorch version at the CATER
            shape (N=4096, S=8, MLP 256, B in (1, 8, 64)) and the CLIPort shape
            (N=576, S=10, MLP 512, B in (1, 8, 16): a 06 sequence's frame, a
            request and the 02 and 04 microbatches, the valid batches and the
            05 batch) and the ResNet SAVi's 8 x 8 grid (N=64, S=8, MLP 256, B
            in (8, 64)), 1 and 3 iterations, each call's
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
            held to 1e-4 of the reference's largest value. The int8 conv
            (``csrc/conv_int8.cu``, the int8 decode's) against its plain
            version, exactly, over every frame, at SAVi's tail (k=5, 64 -> 64
            at 64 x 64; N=1216 and 9728) and at each of ExtendedDINOSAUR's
            four CNN-head layers (k=3) for a CLIPort request's 72 frames and
            a 05 batch's 144: ms, the int8 bound, the plain version's ms, and
            the float path it replaces on the same shapes (conv5, cuDNN's
            float32 conv); conv5 without its ReLU at the BatchNorm upsampling
            decoder's 16 and 32 px for 32 maps, against its plain version,
            with ``F.conv2d`` timed beside; the bf16 variants
            (``tpu.compute_dtype: "bfloat16"``): conv5's at N=1216 and 9728,
            with the ReLU and without, and the ViT attention's at B=8 and 16,
            each within one bf16 step (2**-8 of max |plain|) of its plain
            version run in float32 on the same bf16 inputs, with ms, the bf16
            plain version's ms, the bound at the dense bf16 rate (989 TFLOP/s)
            or 3.35 TB/s, and ``F.conv2d`` / ``F.scaled_dot_product_attention``
            in bf16 as the yardstick; conv5's bf16 Function (the bf16
            backward) at the 02 step's N=4096 and behind the 04 step's
            frozen decoder at N=4608: 2 bf16 launches (forward, input
            gradient) and 1 / 0 weight-gradient calls; the input gradient
            within one bf16 step of its plain version in float32 on the same
            bf16 operands and mask, the weight gradient within
            BF16_WEIGHT_GRAD_STEPS, the bias gradient 1e-4; each part's ms,
            bound and cuDNN's bf16 ``convolution_backward`` of that part;
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
then for each serving path in bf16:
B. bf16_cater, bf16_clipport  the path's served experiment with
            ``tpu.compute_dtype: "bfloat16"`` (the same random weights): its
            live service warmed up, then one 8-row request between a reset and
            a read of the counters (1 slot-attention launch, and 3 bf16 conv5
            or 12 bf16 ViT-attention launches), two more requests and a stage
            split; then, untimed (``bf16_<path>_card``), the path's bf16
            outputs on the card against its float32 ones on the same weights,
            video, noise and captions: the seed's slots and frames within
            ``BF16_SEED_RANGE`` of max |float32|, the predicted frames within
            ``BF16_PRED_MAX`` and ``BF16_PRED_MEAN`` (PERF.md section 2); and
            the first 2 rows against the port's CPU bf16 in the parity worker
            (``bf16_<path>_parity``, printed by ``finish_parities``): within
            2 e(card bf16, card float32) + 2**-8, the CPU tests' rule; after
            the eval path, ``bf16_cater_eval_step``: one 05 step in bf16 at
            B=64, p=19 (its launches, ms, predicted frames a second, peak
            memory);
then on the CATER path's experiment:
S. serve_batching  a ``PredictionService`` at batch 8 behind
            ``serve/batching.py::DynamicBatcher``: two one-row requests
            coalesced into one batch equal, bit for bit, a direct two-row
            predict from the same generator state; then 32 one-row HTTP
            requests from 16 client threads with batching off, at a 20 ms
            window with one dispatcher and with two: requests/s, the clients'
            p50 and p95 ms, the device batches and their mean fill, every
            reply's shape;
E. export_cater, export_clipport, quant_export_cater, bf16_export_cater,
   bf16_quant_export_cater  each serving path's
            service at batch 8, a CATER one with ``decode_quant: int8``
            calibrated on a request's frames, and the CATER one in
            ``tpu.compute_dtype: "bfloat16"`` without and with int8, exported (``serve/export.py``:
            ``predict.pt2``, ``decode.pt2``, ``manifest.json``) with the live
            service's replies to two requests (8 rows float32, 3 rows uint8)
            from a recorded generator state; a fresh process that imports
            ``textocvp_tpu_torch.serve.export`` and what it pulls in
            (``ARTIFACT_WORKER``) loads the five artifacts while the later
            phases run, and at the end (after the parities' lines) answers
            the same requests from the same state: bit for bit as the live
            service, the same launches a request, one slot-attention device
            kernel (and 3 conv5, 3 bf16 conv5, 3 int8-conv or 12
            ViT-attention kernels) a
            request under ``torch.profiler``; the artifact's steady ms a
            request beside the live one's (STEADY_REQUESTS each). Their lines
            come last.

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
12. train   ``textocvp_tpu_torch.cli.train_decomp.main`` at B=64, T=8 over 192
            training videos (3 steps after one B=64 valid batch): finite
            losses, ``checkpoint_last_saved.pt`` and
            ``checkpoint_epoch_final.pt``, 8 slot-attention calls and 3 conv5
            forward and 3 input-gradient launches a step; then
            ``--resume_training`` from ``checkpoint_last_saved`` runs a second
            epoch from the saved step;
13. train_step  the steady B=64 step on the host clock, split into forward,
            backward and optimizer, its peak memory and launches, and one
            step under ``torch.profiler``;
14. train_sign  10 steps on one batch of 8 at lr 4e-4: the loss falls
            (beside M2's ranks, after phase P5);
T1. bf16_train_step  the 02 step in ``tpu.compute_dtype: "bfloat16"`` at
            B=64, T=8 on phase 12's batch, lr 4e-4 without warmup, 10 updates
            on that batch and one noise draw, the phase's main path: the
            first timed cold, its launches (8 slot-attention calls, 3 bf16
            conv5 forward and 3 bf16 input-gradient launches, 3
            weight-gradient calls, no float32 conv5), the second the steady
            step (ms, training frames a second, peak GB), the third split into
            forward, backward and optimizer; finite losses that fall.

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

then SAVi with the JAX package's other encoders and decoders, at the stock
widths on 64 px CATER frames:
R.  resnet_savi  the 01 CLI's SAVi experiment with the ``ResNet`` encoder
            (ResNet-34, GroupNorm of 32 groups, an 8 x 8 grid of 512
            features): the 02 CLI at B=64, T=8 for 2 steps after a B=64
            valid batch over a set of 128 + 64 videos, the 03 CLI on its
            checkpoint (one B=64 batch), and one 8-row request of a service
            on it with the CATER path's random TextOCVP_T5, p=19: the phase's
            main path (finite losses, the checkpoint, ``results.json``, the
            reply; slot attention at N=64 and conv5 launched); then, off it,
            the trained ResNet SAVi's ``decompose`` and decode of B=2, T=2 in
            ``eval()`` and a random SAVi with a BatchNorm decoder that
            upsamples 8 -> 64 px (conv5 at 16, 32 and 64 px without its
            ReLU) in ``train()``, each on the card against the CPU, TF32 off:
            slots, masks and frames within 1e-4 of their largest value; the
            phase's launches, peak memory and seconds.

then the predictor-train path, over the experiment that phase 12 trained:
15. pred_train_parity  PredictorTrainer on the card and on the CPU at full
            width, B=2, c=1, p=2 (``PARITY_PREDS``), the same weights, video, captions and slot noise,
            warmup off, the CPU with the card's ReLU masks as in phase 11
            (its own-mask result reported): the loss (1e-5 relative) and every
            trainable gradient leaf (1e-4 of its largest value) after one
            step, the loss and the parameters after two;
16. pred_train  ``textocvp_tpu_torch.cli.train_predictor.main`` at B=64 over
            the phase-12 set (3 steps after one valid batch), its frozen SAVi
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
18. pred_train_sign  10 steps on one batch of 8 at lr 1e-4: the loss falls
            (beside M2's ranks);
T2. bf16_pred_train_step  phase T1 for the 04 step at B=64, c=1, p=9
            through phase 12's SAVi in bf16, lr 1e-4, 5 updates: 10
            slot-attention calls, 3 bf16 conv5 forward and 3 input-gradient
            launches a step, no weight gradient; the split adds the frozen
            encode;
F1. figs_parity  06b's figures of one sequence at p=3 on the card and on the
            CPU with the same initial slots: every array a figure writer is
            handed within 1e-4 of the largest value it or the decoded
            predictions (before their clip to [0, 1]) hold, the two
            argmax-coloured GIFs' frames on all but 1e-3 of their pixels;
            each rollout step's slots and the decode of the same slots on
            both devices reported beside;
R2. conv_decoder_tails  SAVi's decoder with tails that conv5 does not take
            (3 x 3; 5 x 5 at 32 and 128 channels; stride 2), random weights
            at CATER's width, decoding one frame's 8 slots on the card and on
            the CPU, in float32 (1e-4 of the largest value) and bf16 (2 e(card
            bf16, card float32) + 2**-8 of the CPU's bf16), the 3 x 3 one
            under int8 too (within int8's own error of the CPU's; 3 int8-conv
            launches); no conv5 launch;
F2. figs    the 06 CLIs (``cli/generate_figs_decomp.py`` on phase 12's
            SAVi, ``cli/generate_figs_predictor.py`` on phase 16's
            TextOCVP_T5 at c=1, p=19), one sequence each, then again on a
            bf16 copy of the two experiments
            (``bf16_figs``: the bf16 conv5's launches): every figure and
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
            1 step after one valid batch over a set of 64 + 64 videos: the
            launches of phase 16, the checkpoints, a resumed epoch, the 05
            CLI on its checkpoint; then the steady step split and profiled
            as phase 17.

then the CLIPort chain, over the color-cache set:
19. clip_train_parity  DecompTrainer on ExtendedDINOSAUR on the card and on
            the CPU at full width, B=2, T=3, as phase 11, the CPU with the
            card's masks (every ReLU on the gradient's path, the slot-attention
            MLP's from the card's recompute, the loss's clips); the BatchNorm
            statistics after the first step (1e-5), the ViT bit for bit;
20. clip_train  the 02 CLI at B=64, T=8, ``accum_steps`` 8: one epoch of
            one step after a B=16 valid batch, then ``--resume_training`` for a
            second; 8 slot-attention calls and 12
            ViT-attention launches a (micro)batch, the checkpoints hold the ViT
            and the statistics;
21. clip_train_step  the steady step on the host clock, split into forward,
            backward (each summed over the microbatches) and optimizer, its
            peak memory, launches, and one step under ``torch.profiler``;
22. clip_train_sign  5 steps on one batch of 8 at lr 1e-6: the loss falls;
23. clip_pred_train_parity, clip_pred_train, clip_pred_train_step,
            clip_pred_train_sign  the same for the 04 step through the frozen
            ExtendedDINOSAUR of phase 20 (B=64, c=1, p=9, ``accum_steps`` 8;
            one epoch, then a resume; 10 slot-attention calls and 12
            ViT-attention launches a microbatch; the parity at p=2, through
            a random ExtendedDINOSAUR, beside M2's ranks);
T3. bf16_clip_train_step, bf16_clip_pred_train_step  (after phases 22 and
            23) phase T1 for the CLIPort 02 step (lr 1e-6) and 04 step (lr
            1e-4) at B=64, ``accum_steps`` 8, 3 updates each: a step's 12 bf16
            ViT-attention launches a microbatch and no float32 ViT launch;
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

then int8 (``tpu.decode_quant`` / ``tpu.encode_quant``, ``models/quant.py``):
Q1. quant_eval  the 05 CLI at B=64, p=19 on a copy of the eval path's
            predictor experiment with ``decode_quant: int8`` (random
            weights): ``results.json``'s flags, each metric's mean against
            phase 9's float run, 2 slot-attention calls, 3 conv5 launches
            (the first batch's float calibration) and 3 int8-conv launches a
            batch, the decode stage's ms int8 against float32;
Q2. clip_quant_eval  the same for CLIPort at B=16, p=9 with both modes, on
            phase 23's predictor (02 and 04 trained a few steps), against
            phase 25: 4 int8-conv launches a batch, 12 ViT-attention
            launches a batch and 12 more for the first batch's calibration.
Q3. bf16_quant_eval, bf16_clip_quant_eval  Q1 and Q2 in
            ``tpu.compute_dtype: "bfloat16"``: the calibration through conv5's
            bf16 kernel (3 launches) or the bf16 ViT attention (12), no
            float32 conv5 or ViT-attention launch, and the framewise PSNR
            against the bf16 05 evaluator's without int8 on the same batches
            within BF16_INT8_PSNR_LOSSES times Q1's / Q2's largest framewise
            int8 loss plus BF16_INT8_PSNR_DB.

and the host input and the trainers' extras:
H1. host_io  what the machine offers the host input path (``native.host_io``:
            the compiler, the build against zlib, PIL, imageio and ffmpeg,
            tensorboard), the ``native/imgio.cpp`` build and its
            seconds, the C++ resize against ``resize_bilinear_plain`` on
            320 x 240 -> 64 x 64 and 640 x 480 -> 336 x 336 frames and PNGs
            of the stdlib writer (rows through filter types 0-4) decoded back,
            bit for bit; decode plus resize in frames/s on 1 thread and 8;
H2. png_eval  (after ``mesh_shared_card``'s ranks) the CATER 05 CLI at B=64, p=19 over 64
            frame-directory videos of 21 PNG frames at 320 x 240 (8 loader
            threads); the ``.npy`` caches ``cli/make_npy_cache.py`` builds
            from them hold the same items bit for bit, so the cache route's
            05 gives the same ``results.json``; the loader's frames/s against the step's
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
            one CLIPort 04 microbatch of 8 with remat timed cold, and one of
            16 (``accum_steps`` 4), its peak; the CLIPort 05 CLI at
            B=16, p=9 over 16 test episodes of 12 PNG frames at 640 x 480
            without a cache, against the cache route as H2.

and the mesh (``parallel/``), in processes of their own (``spawn_mesh``,
``start_mesh``, ``wait_mesh``, ``run_mesh``; deterministic cuDNN and cuBLAS
there), started before the four other predictors' phases, where they
import and wait: M2's two ranks go beside phases that time nothing (the
card halves of the trainer parities 11, 15, P4, 19 and 23, of the bf16
trainer parities and of the bf16 services' checks, and the CATER sign
checks 14 and 18), and are waited for before H2; M1 goes alone on the card after phase E, then M2's
line. The CLIPort color-cache set and the PNG sets of H2 and H4 are
written by two processes of their own (``start_fixtures``) beside phases 2
and 3, waited for before H1:
M1. mesh_nccl  a process group of one rank over NCCL, started through the
            ``TEXTOCVP_*`` environment, ``tpu.mesh_axes`` ``{"data": -1,
            "model": 1}``: two CATER 02 steps and two 04 steps at B=64, the
            CATER 05 batch (B=64, p=19) and an 8-row served request, first
            without the group, then through the mesh: parameters,
            ``results.json`` and the reply bit for bit, the steps' ms side
            by side;
M2. mesh_shared_card  two ranks on the one card over gloo, every service
            at a smaller depth (``MESH_PREDS``: 5 CATER, 3 CLIPort predicted
            frames): the CATER service at batch 8 on ``data=1, model=2``
            (float reply within 1e-4 of its largest value of one process's),
            ``data=2`` (1e-5) and at batch 1 under sequence-parallel decode
            (1e-5); the CLIPort one at batch 2 on ``data=1, model=2`` (1e-4),
            at batch 1 under sequence-parallel decode (1e-4) and with int8 at
            ``data=2``; in bf16 the CATER service at ``data=2`` (1e-5 too)
            and ``data=1, model=2`` and the CLIPort one at ``data=1,
            model=2``, each within 2 e(one process bf16, one process float32)
            + 2**-8 of one process's bf16 reply, each request timed; a CATER 04 step at B=8, p=3
            on ``model=2`` against world size 1 (losses 1e-5, the global
            norm 1e-4, no parameter more than 0.5 lr apart after the update),
            and in bf16 against world size 1's bf16 step by the bf16 rule
            (losses, norm; leaf by leaf the elements more than 0.5 lr apart,
            a check shown to reject a planted unchanged or flipped leaf), the
            replicated leaves bit-equal across the ranks; then both ranks
            raise on purpose in the float32 step's trainer's loop and
            each writes its own file of the emergency checkpoint with no
            collective, rank 0's join of the two bit for bit the gathered
            state; slot attention and conv5 launched by the mesh itself (the
            references not counted); each rank's peak memory.

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
paths, the first runs of the CLIs of phases 20, 23 and 25 the CLIPort
chain's three, and the updates of T1, T2 and T3 the bf16 training paths':
every kernel's launch counter (and conv5's input-gradient
launches and weight-gradient calls) is set to 0 before it and read after.
The bf16 trainer parities (``bf16_train_parity``, ``bf16_pred_train_parity``,
``bf16_clip_train_parity``, ``bf16_clip_pred_train_parity``): one step
at B=2 (CATER 02 T=3, 04 p=2 through phase 12's SAVi; CLIPort 02 T=2, 04
p=1 through a random ExtendedDINOSAUR) in float32 and in bf16 on the card
from the same weights, video and noise, and in bf16 on the CPU with every
kink of the card's bf16 run replayed: the loss, every gradient leaf and
the BatchNorm statistics' moves within 2 e(card bf16, card float32) +
2**-8, e over max |card float32|; their card halves run beside M2's ranks.
The trainer parities (11, 15, P4, 19, 23 and the bf16 ones) run their card
half in place and hand their CPU half to one spawned worker process
(``parity_pool``, 4 torch threads), which works through them while the later
phases use the card; their lines, checked as before, come after phase H4
(``finish_parities``), each with ``cpu_half.waited_s_after_submit``.
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
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from contextlib import contextmanager
from dataclasses import dataclass
from functools import partial
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
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
TENSOR_CORE_KERNELS = ("conv5", "vit_attention", "conv_int8")
VIT_HEADS, VIT_TOKENS, VIT_DH = 12, 577, 64  # DINOv2 ViT-B/14 at 336 px
CONV5_RES, CONV5_CH = 64, 64                 # SAVi decoder tail on CATER
EVAL_BATCH, EVAL_PREDS, EVAL_VIDEOS = 64, 19, 128
TRAIN_BATCH, TRAIN_FRAMES = 64, 8                  # bench_train.py's flagship step
# 3 steps, 1 valid batch: the 02 and 04 CLIs' paths at the fewest steps that
# still show the loop, so that the whole run keeps inside its time limit
TRAIN_VIDEOS, TRAIN_VALID_VIDEOS = 3 * TRAIN_BATCH, TRAIN_BATCH
GRAD_TOLERANCE = 1e-4  # gradients: max abs error over the reference's max |value|
# steps of the sign checks on one batch: the CATER ones at lr 4e-4 / 1e-4 and
# the CLIPort ones at 1e-6 / 1e-4 all fell by 45-85 % within these
SIGN_STEPS, CLIP_SIGN_STEPS = 10, 5
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
# the slot-attention query bias and slot LayerNorm bias: the softmax over
# slots does not see a shift common to every slot
SLOT_EXACT_ZERO = ("slot_attention.to_q.bias", "slot_attention.norm_slot.bias")


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


def timed_once(fn):
    """``fn()`` once between CUDA events: (its result, its ms). For a plain
    version whose one pass is both the check's reference and its time."""
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def max_abs_diff(a, b, chunk=1024):
    """max |a - b| in float32 over the first axis in chunks (no full-size temporary)."""
    return max((a[i:i + chunk].float() - b[i:i + chunk].float()).abs().max().item()
               for i in range(0, a.shape[0], chunk))


FENCE_KERNEL = "spin_kernel"  # torch.cuda._sleep's
FENCE_SPINS = (8, 64, 192, 512)  # spins of about 12 ms before a traced call, by attempt
# where in FENCE_SPINS a trace starts: the fence the process's last whole
# trace needed (the stretch the profiler drops grows with the process's age)
FENCE_FIRST = [0]


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
    and now and then falls back to none; now and then it drops a trace's
    last records too. A trace counts only if a spin of the first fence comes
    before ``fn``'s first device record and a spin of the last after its
    last one, so that no record of ``fn`` can be missing. Where the first
    fence's spins are gone, ``fn`` runs again behind the next fence of
    FENCE_SPINS; where only the last fence's are, behind the same one (a
    longer first fence does not bring back a trace's end); after
    len(FENCE_SPINS) attempts, or where the longest fence was not enough,
    the check fails. A trace starts behind the fence that the process's last
    whole trace needed (``FENCE_FIRST``), so that a process pays for a
    failed first attempt once, not at every trace: on an H100 most traces
    after a run's first minutes needed 64 spins, and each failed first
    attempt cost a whole call and the reading of its trace. (A lost end that
    lengthened the first fence made every later trace of a run wait 6 s
    behind 512 spins: 70 s more in one run, PERF.md section 6.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if cpu else []
    index = FENCE_FIRST[0]
    for _ in FENCE_SPINS:
        spins = FENCE_SPINS[index]
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
        head = bool(body) and 0 < body[0]
        if head and body[-1] < len(names) - 1:
            FENCE_FIRST[0] = index
            return prof, wall_ms, spins
        if not head:
            if index == len(FENCE_SPINS) - 1:
                break
            index += 1
    check(False, f"no whole trace behind {spins} fence spins: the last one held "
                 f"{len(names)} device records, {len(body)} of the call, first {names[:3]}, "
                 f"last {names[-2:]}")


@dataclass
class DeviceRecord:
    """A trace's device events of one name, as ``prof.key_averages()``
    groups them: the name, the count and their device microseconds."""
    key: str
    count: int
    self_device_time_total: float


def device_records(prof):
    """The device entries of a trace by name (``DeviceRecord``; the entries
    of ``prof.key_averages()`` on the device), the fences left out. Read from
    the trace's kineto events once: ``key_averages`` first builds a Python
    object for every event, host and device, many times slower on a trace
    of a CLIPort predictor step's 101,500 kernels
    (``tests/test_torch_port_chip_smoke.py`` holds the two to each other and
    times them)."""
    from torch.autograd import DeviceType

    records, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_hidden_event():
            continue
        raw = e.name()
        name = names.get(raw)
        if name is None:
            name = names[raw] = torch._C._demangle(raw)  # key_averages' name
        if FENCE_KERNEL in name:
            continue
        r = records.get(name)
        if r is None:
            r = records[name] = DeviceRecord(name, 0, 0.0)
        r.count += 1
        r.self_device_time_total += e.duration_ns() / 1e3
    return list(records.values())


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


# the kernels on warpgroup MMA: (library, kernel function, its SASS instruction)
GMMA_KERNELS = (("vit_attention", "attention_bf16_kernel", "HGMMA"),
                ("conv_int8", "conv_int8_kernel", "IGMMA"),
                ("conv5", "conv5_bf16_kernel", "HGMMA"))
# how ptxas's notes that it serialised a kernel's wgmma begin (C7512: too few
# registers; C7518: a wgmma on a divergent path; C7519: warpgroup.arrive
# injected, as a runtime loop over the taps gave)
WGMMA_SERIALISED = "Potential Performance Loss"


def kernel_ptxas(report: str, kernel: str) -> list:
    """``ptxas -v``'s lines about one kernel function of a library's report:
    from its "Compiling entry function" line to its register count, and any
    line elsewhere that names it (ptxas's performance notes)."""
    lines, inside = [], False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        if inside or (kernel in line and "Compiling entry function" not in line):
            lines.append(line.strip())
        if inside and "Used" in line and "registers" in line:
            inside = False
    return lines


def phase_build():
    """Builds every source; prints each library's ``ptxas -v`` lines and the
    tensor-core instructions of each kernel function in its SASS. Returns
    {kernel function: count} of the GMMA_KERNELS' instruction."""
    from concurrent.futures import ThreadPoolExecutor

    from textocvp_tpu_torch.ops import build

    t = time.perf_counter()
    built = build.build_all()
    seconds = time.perf_counter() - t
    libs = {}
    with ThreadPoolExecutor(len(build.sources())) as pool:  # one cuobjdump a library at once
        sass = dict(zip(build.sources(), pool.map(
            lambda src: build.tensor_core_by_function(src.stem), build.sources())))
    for src in build.sources():
        report = build.ptxas_report(src.stem)
        by_function = sass[src]
        tensor_core = sum(sum(ops.values()) for ops in by_function.values())
        print(f"{src.stem}: {tensor_core} tensor-core SASS instructions\n{report}", flush=True)
        libs[src.stem] = {"tensor_core_sass": tensor_core, "ptxas": report.splitlines(),
                          "by_function": {f: {op: c for op, c in ops.items() if c}
                                          for f, ops in by_function.items()}}
    gmma = {kernel: sum(ops.get(op, 0) for f, ops in libs[stem]["by_function"].items()
                        if kernel in f) for stem, kernel, op in GMMA_KERNELS}
    emit({"phase": "build", "seconds": seconds, "built": built,
          "sources": [str(p.relative_to(ROOT)) for p in build.sources()],
          "headers": [str(p.relative_to(ROOT)) for p in build.headers()], "libraries": libs,
          "gmma": {f"{kernel} {op}": gmma[kernel] for _, kernel, op in GMMA_KERNELS}})
    for stem in TENSOR_CORE_KERNELS:
        check(libs[stem]["tensor_core_sass"] > 0, f"{stem}: no tensor-core instruction in its SASS")
    for stem, kernel, op in GMMA_KERNELS:
        check(gmma[kernel] > 0, f"{stem}: no {op} in {kernel}'s SASS")
        lines = kernel_ptxas("\n".join(libs[stem]["ptxas"]), kernel)
        print(f"{kernel}: " + " | ".join(lines), flush=True)
        spills = [int(n) for line in lines for n in re.findall(r"(\d+) bytes spill", line)]
        check(not any(spills), f"{kernel} spills: {lines}")
        check(not any(WGMMA_SERIALISED in line for line in lines),
              f"ptxas serialised {kernel}'s wgmma: {lines}")
    bf16_conv = [o for f, o in libs["conv5"]["by_function"].items() if "conv5_bf16_kernel" in f]
    check(bf16_conv and all(o.get("HMMA", 0) == 0 for o in bf16_conv),
          f"conv5_bf16_kernel runs warp-level HMMA: {bf16_conv}")
    return gmma


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
    request's and an eval batch's. The plain version runs once over all
    frames (about 50 GB at N=9728): that pass is both the reference of the
    error, over every frame, and ``plain_ms``. The kernel's times cover all
    frames, fewer repetitions at N=9728. The yardstick is ``F.conv2d``
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
        ref, plain_ms = timed_once(lambda: c5.conv5_plain(x, w, b))
        err = max_abs_diff(out, ref)
        finite = bool(torch.isfinite(out).all())
        del out, ref
        torch.cuda.empty_cache()
        # float32 on both sides, 1600-term sums in other orders, outputs of order 1
        check(finite and err <= 1e-4, f"conv5 vs plain at N={n}: {err} > 1e-4")
        ms = cuda_ms(lambda: c5.conv5_cuda(x, w, b), reps=reps, warmup=1)
        launches = c5.conv5_cuda.launches - launches
        lib_cl = cuda_ms(lambda: F.relu_(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=2)),
                         reps=reps, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        lib_nchw = cuda_ms(lambda: F.relu_(F.conv2d(x_nchw, w_oihw, b, padding=2)),
                           reps=reps, warmup=1)
        del x_nchw, x
        torch.cuda.empty_cache()
        bound_ms, bound_by, fp32_ms = conv5_bounds(n, res, res, c)
        layout = "nchw" if lib_nchw <= lib_cl else "channels_last"
        rows.append({"N": n, "H": res, "W": res, "C": c, "max_abs_err": err,
                     "err_frames": "all", "ms": ms,
                     "plain_ms": plain_ms, "library_ms": min(lib_nchw, lib_cl),
                     "library_layout": layout,
                     "library_ms_by_layout": {"nchw": lib_nchw, "channels_last": lib_cl},
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_ms_fp32_cores": fp32_ms, "launches": launches, "reps": reps})
    return rows


def conv5_variant_rows():
    """conv5 at the BatchNorm upsampling decoder's tail (``BN_UP_DECODER``):
    16 and 32 px (64 px is ``conv5_rows``'), without the ReLU, which follows
    the BatchNorm there, for the card-against-CPU decode's B x T x 8 maps;
    against its plain version, every frame, with ``F.conv2d`` (cuDNN, TF32
    off) timed as a yardstick on the channels-last view."""
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import conv5 as c5

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED + 5)
    c = CONV5_CH
    w = (torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5).cuda()
    b = (0.1 * torch.randn((c,), generator=gen)).cuda()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    n = VARIANT_PARITY[0] * VARIANT_PARITY[1] * 8
    rows = []
    for res in (16, 32):
        x = torch.randn((n, res, res, c), generator=gen).cuda()
        launches = c5.conv5_cuda.launches
        out = c5.conv5_cuda(x, w, b, relu=False)
        ref, plain_ms = timed_once(lambda: c5.conv5_plain(x, w, b, relu=False))
        err = (out - ref).abs().max().item()
        check(bool(torch.isfinite(out).all()) and err <= 1e-4,
              f"conv5 vs plain at N={n}, {res} px, no ReLU: {err} > 1e-4")
        ms = cuda_ms(lambda: c5.conv5_cuda(x, w, b, relu=False), hold=True)
        library_ms = cuda_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=2),
                             hold=True)
        bound_ms, bound_by, fp32_ms = conv5_bounds(n, res, res, c)
        rows.append({"N": n, "H": res, "W": res, "C": c, "relu": False, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "library_layout": "channels_last", "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_ms_fp32_cores": fp32_ms,
                     "launches": c5.conv5_cuda.launches - launches})
    return rows


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


# The bf16 variants (tpu.compute_dtype "bfloat16") round their float32 result
# once to bf16. Each is held against its plain version run in float32 on the
# same bf16 inputs, within one bf16 step at the largest value (BF16_STEP of
# max |plain|): the one rounding moves a value by at most half a step of its
# own binade. Against the bf16 plain version, which rounds its own float32
# sum, a value whose two sums straddle a rounding edge differs by a whole
# step of its binade (up to 2 BF16_STEP of the max); that distance is
# reported as ``max_steps_vs_bf16_plain``.
BF16_STEP = 2.0 ** -8


def bf16_steps(out, ref):
    """max |out - ref| in bf16 steps at the largest |ref| (BF16_STEP * max |ref|)."""
    return ((out.float() - ref.float()).abs().max() / (BF16_STEP * ref.float().abs().max())).item()


def conv5_bf16_bounds(n, h, w, c):
    """bf16 x read once and bf16 out written once, bf16 weights and the
    float32 bias read once; the products at the dense bf16 rate."""
    nbytes = 2 * 2 * n * h * w * c + 2 * 25 * c * c + 4 * c
    return bound(nbytes, 2 * 25 * c * c * n * h * w + 2 * n * h * w * c, BF16_FLOP_PER_S)


def conv5_bf16_rows():
    """conv5's bf16 variant at a CATER request's and an eval batch's map
    counts, with the ReLU and without, against its plain version in float32
    on the same bf16 inputs, every frame: one pass of the bf16 plain
    version's arithmetic (the float32 sums and the bias, ReLU, then the one
    rounding to bf16, as ``conv5_plain`` of a bf16 ``x``), timed, is the
    reference of both distances and ``plain_ms``; with ``F.conv2d`` in bf16,
    channels-last, with the bias and the ReLU (cuDNN) as the yardstick."""
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import conv5 as c5

    gen = torch.Generator().manual_seed(SEED + 12)
    xgen = torch.Generator("cuda").manual_seed(SEED + 12)
    c, res = CONV5_CH, CONV5_RES
    w = (torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5).cuda().to(torch.bfloat16)
    b = (0.1 * torch.randn((c,), generator=gen)).cuda()
    w_oihw, b16 = w.permute(3, 2, 0, 1).contiguous(), b.to(torch.bfloat16)
    rows = []
    for n, reps in ((BATCH * 19 * 8, 10), (EVAL_BATCH * EVAL_PREDS * 8, 2)):
        x = torch.randn((n, res, res, c), device="cuda", generator=xgen).mul_(0.5)
        x = x.to(torch.bfloat16)

        def plain(relu):  # conv5_plain's bf16 contract, its float32 sum kept
            ref = c5.conv5_plain(x.float(), w.float(), b, relu)
            return ref, ref.to(torch.bfloat16)

        for relu in (True, False):
            launches = c5.conv5_bf16_cuda.launches
            out = c5.conv5_bf16_cuda(x, w, b, relu)
            (ref, ref16), plain_ms = timed_once(lambda: plain(relu))
            finite = bool(torch.isfinite(out).all())
            err = max_abs_diff(out, ref)
            top = ref.abs().max().item()
            steps = err / (BF16_STEP * top)
            steps_bf16 = max_abs_diff(out, ref16) / (BF16_STEP * ref16.float().abs().max().item())
            del out, ref, ref16
            torch.cuda.empty_cache()
            check(finite and steps <= 1, f"conv5 bf16 vs plain at N={n}, relu={relu}: "
                                         f"{steps} bf16 steps > 1")
            ms = cuda_ms(lambda: c5.conv5_bf16_cuda(x, w, b, relu), reps=reps, warmup=1)
            launches = c5.conv5_bf16_cuda.launches - launches
            act = F.relu_ if relu else (lambda y: y)
            library_ms = cuda_ms(lambda: act(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b16,
                                                      padding=2)), reps=reps, warmup=1)
            torch.cuda.empty_cache()
            bound_ms, bound_by = conv5_bf16_bounds(n, res, res, c)
            rows.append({"N": n, "H": res, "W": res, "C": c, "relu": relu, "max_abs_err": err,
                         "max_err_steps": steps, "max_steps_vs_bf16_plain": steps_bf16,
                         "err_frames": "all", "ms": ms,
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "library_layout": "channels_last", "bound_ms": bound_ms,
                         "bound_by": bound_by, "launches": launches, "reps": reps})
        del x
        torch.cuda.empty_cache()
    return rows


def vit_attention_bf16_rows():
    """The ViT attention's bf16 variant at a request's (B=8) and the 05
    batch's (B=16) frames against its plain version in float32 on the same
    bf16 inputs, with the bf16 plain version's time and
    ``F.scaled_dot_product_attention`` in bf16 as the yardstick."""
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import vit_attention as va

    scale = VIT_DH ** -0.5
    gen = torch.Generator().manual_seed(SEED + 13)
    rows = []
    for b in (BATCH, CLIP_EVAL_BATCH):
        q, k, v = (torch.randn((b, VIT_HEADS, VIT_TOKENS, VIT_DH), generator=gen).cuda()
                   .to(torch.bfloat16) for _ in range(3))
        launches = va.vit_attention_bf16_cuda.launches
        out = va.vit_attention_bf16_cuda(q, k, v, scale)
        ref = va.vit_attention_plain(q.float(), k.float(), v.float(), scale)
        torch.cuda.synchronize()
        steps = bf16_steps(out, ref)
        check(bool(torch.isfinite(out).all()) and steps <= 1,
              f"ViT attention bf16 vs plain at B={b}: {steps} bf16 steps > 1")
        ms = cuda_ms(lambda: va.vit_attention_bf16_cuda(q, k, v, scale), hold=True)
        plain_ms = cuda_ms(lambda: va.vit_attention_plain(q, k, v, scale))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                             hold=True)
        bound_ms, bound_by = bound(2 * 4 * b * VIT_HEADS * VIT_TOKENS * VIT_DH,
                                   4 * b * VIT_HEADS * VIT_TOKENS ** 2 * VIT_DH, BF16_FLOP_PER_S)
        rows.append({"B": b, "h": VIT_HEADS, "n": VIT_TOKENS, "dh": VIT_DH,
                     "max_abs_err": (out.float() - ref).abs().max().item(),
                     "max_err_steps": steps,
                     "max_steps_vs_bf16_plain": bf16_steps(out, ref.to(torch.bfloat16)),
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "launches": va.vit_attention_bf16_cuda.launches - launches})
    return rows


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
                           warmup=0)
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


# conv5's bf16 weight gradient against its plain version in float32 on the
# same bf16 operands, in bf16 steps at the largest value: one for the result's
# rounding, one for float32 sums of 19M products each taken in another order
BF16_WEIGHT_GRAD_STEPS = 2


def conv5_bf16_weight_grad_bounds(n, h, w, c):
    """bf16 x and g' read once, the bf16 dW written once; 25 products over
    every pixel at the dense bf16 rate."""
    return bound(2 * (2 * n * h * w * c + 25 * c * c), 2 * 25 * c * c * n * h * w,
                 BF16_FLOP_PER_S)


def conv5_bf16_backward_rows():
    """conv5's bf16 Function on the card at the 02 step's N=4096 (both
    gradients) and behind the 04 step's frozen decoder at N=4608 (the input
    gradient only), the output gradient strided as autograd hands it back:
    its launches, then each part against its plain version in float32 on
    the same bf16 operands and the same mask (the kernel's bf16 output's):
    the input gradient (the bf16 kernel's launch on the masked gradient with
    the rotated weights) within one bf16 step, the weight gradient (25
    bf16 GEMMs with float32 sums) within BF16_WEIGHT_GRAD_STEPS, the bias
    gradient (a float32 sum) within GRAD_TOLERANCE. Each part timed against
    its bound and cuDNN's bf16 ``convolution_backward`` of the same masked
    gradient (channels-last), that part alone."""
    from textocvp_tpu_torch.ops import conv5 as c5

    gen = torch.Generator().manual_seed(SEED + 14)
    cgen = torch.Generator("cuda").manual_seed(SEED + 14)
    c, res = CONV5_CH, CONV5_RES
    bf16 = torch.bfloat16
    rows = []
    for n, train_w in ((TRAIN_BATCH * TRAIN_FRAMES * 8, True), (PRED_TAIL_N, False)):
        w = (torch.randn((5, 5, c, c), generator=gen) / (25 * c) ** 0.5).cuda()
        b = (0.1 * torch.randn((c,), generator=gen)).cuda()
        w.requires_grad_(train_w)
        b.requires_grad_(train_w)
        x = torch.randn((n, res, res, c), device="cuda", generator=cgen).mul_(0.5).to(bf16)
        x.requires_grad_()
        g = torch.randn((n, c, res, res), device="cuda", generator=cgen).to(bf16)
        g = g.permute(0, 2, 3, 1)
        leaves = (x, w, b) if train_w else (x,)
        before = launches(), c5.conv5_weight_grad.calls
        y = c5.conv5(x, w, b)
        got = torch.autograd.grad(y, leaves, g)
        torch.cuda.synchronize()
        counts = {k: v - before[0][k] for k, v in launches().items()}
        calls = c5.conv5_weight_grad.calls - before[1]
        check(counts == every_kernel({"conv5_bf16": 2, "conv5_bf16_input_grad": 1})
              and calls == int(train_w),
              f"conv5 bf16 Function at N={n}: launches {counts}, weight-gradient calls {calls}")
        with torch.no_grad():
            xd, wd, bd = x.detach(), w.detach(), b.detach()
            gm = torch.where(y > 0, g, 0).contiguous()  # the mask of the kernel's output
            del y, g
            w_rot = wd.to(bf16).flip(0, 1).transpose(2, 3).contiguous()
            zeros = torch.zeros_like(bd)
            dx_ref, plain_ms = timed_once(
                lambda: c5.conv5_plain(gm.float(), w_rot.float(), zeros, relu=False))
            errs = {"x": bf16_steps(got[0], dx_ref)}
            abs_err = {"x": max_abs_diff(got[0], dx_ref)}
            del dx_ref
            torch.cuda.empty_cache()
            if train_w:
                dw_ref, plain_w_ms = timed_once(lambda: c5.conv5_weight_grad(xd.float(),
                                                                             gm.float()))
                errs["w"] = bf16_steps(got[1], dw_ref)
                abs_err["w"] = (got[1] - dw_ref).abs().max().item()
                errs["b_rel"] = rel_err(got[2], gm.float().sum((0, 1, 2)))
                del dw_ref
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            del got
            torch.cuda.empty_cache()
            check(finite and errs["x"] <= 1 and errs.get("w", 0) <= BF16_WEIGHT_GRAD_STEPS
                  and errs.get("b_rel", 0) <= GRAD_TOLERANCE,
                  f"conv5 bf16 backward vs plain at N={n}: {errs} (bf16 steps; limits 1, "
                  f"{BF16_WEIGHT_GRAD_STEPS}, b {GRAD_TOLERANCE} relative)")
            before = c5.conv5_bf16_input_grad_cuda.launches
            dx_ms = cuda_ms(lambda: c5.conv5_bf16_input_grad_cuda(gm, w_rot, zeros), reps=3,
                            warmup=1)
            kernel_launches = c5.conv5_bf16_input_grad_cuda.launches - before
            w_oihw = wd.to(bf16).permute(3, 2, 0, 1).contiguous()
            gl = gm.permute(0, 3, 1, 2)  # NCHW shape, channels-last memory
            xl = xd.permute(0, 3, 1, 2)

            def library(mask):
                return cuda_ms(lambda: torch.ops.aten.convolution_backward(
                    gl, xl, w_oihw, [c], [1, 1], [2, 2], [1, 1], False, [0, 0], 1, mask),
                    reps=3, warmup=1)

            dx_bound, dx_by = conv5_bf16_bounds(n, res, res, c)
            row = {"N": n, "H": res, "W": res, "C": c, "weights_train": train_w,
                   "launches": counts, "weight_grad_calls": calls, "err_steps": errs,
                   "input_grad": {"ms": dx_ms, "plain_ms": plain_ms,
                                  "library_ms": library([True, False, False]),
                                  "bound_ms": dx_bound, "bound_by": dx_by,
                                  "max_err_steps": errs["x"], "max_abs_err": abs_err["x"],
                                  "launches": kernel_launches}}
            if train_w:
                dw_bound, dw_by = conv5_bf16_weight_grad_bounds(n, res, res, c)
                row["weight_grad"] = {
                    "ms": cuda_ms(lambda: c5.conv5_weight_grad_bf16(xd, gm), reps=3, warmup=1),
                    "plain_ms": plain_w_ms, "library_ms": library([False, True, False]),
                    "bound_ms": dw_bound, "bound_by": dw_by, "max_err_steps": errs["w"],
                    "max_abs_err": abs_err["w"],
                    "route": "torch.matmul: 25 bf16 GEMMs over every pixel of every frame, "
                             "float32 accumulation and split-K reductions"}
                row["bias_grad_ms"] = cuda_ms(lambda: gm.float().sum((0, 1, 2)), reps=3,
                                              warmup=1)
        rows.append(row)
        del x, xd, gm, w_rot, gl, xl
        torch.cuda.empty_cache()
    return rows


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
            # the ResNet SAVi's 8 x 8 grid: a request (B=8), the 02 and 03 batches
            "slot_attention_resnet": slot_attention_rows(64, 8, 256, (BATCH, TRAIN_BATCH)),
            "conv5": conv5_rows(),
            "conv5_upsample": conv5_variant_rows(),
            "conv_int8": conv_int8_rows(),
            "conv5_bf16": conv5_bf16_rows(),
            "vit_attention_bf16": vit_attention_bf16_rows(),
            "conv5_backward": conv5_backward_rows(),
            "conv5_frozen_backward": conv5_frozen_backward_rows(),
            "conv5_bf16_backward": conv5_bf16_backward_rows(),
            "slot_attention_backward": slot_attention_backward_rows(
                TRAIN_BATCH, CONV5_RES * CONV5_RES, 8, 256, SEED + 7),
            # the CLIPort 02 microbatch: B=8 videos a frame, N=576, S=10, MLP 512
            "slot_attention_backward_clipport": slot_attention_backward_rows(
                CLIP_TRAIN_BATCH // CLIP_ACCUM, CLIP_PATCHES, 10, 512, SEED + 11)}
    emit({"phase": "kernels", "tolerance_abs": {"slot_attention": 1e-4, "vit_attention": 2e-5,
                                                "conv5": 1e-4, "conv_int8": 0},
          "tolerance_bf16_steps": {"conv5_bf16": 1, "vit_attention_bf16": 1,
                                   "conv5_bf16_input_grad": 1,
                                   "conv5_bf16_weight_grad": BF16_WEIGHT_GRAD_STEPS,
                                   "step": "2**-8 of max |plain|, plain in float32"},
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
    from textocvp_tpu_torch.ops import conv_int8 as ci
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.ops import vit_attention as va

    return {"slot_attention": sak.slot_attention_cuda, "vit_attention": va.vit_attention_cuda,
            "conv5": c5.conv5_cuda, "conv_int8": ci.conv_int8_cuda,
            "vit_attention_bf16": va.vit_attention_bf16_cuda, "conv5_bf16": c5.conv5_bf16_cuda,
            "conv5_bf16_input_grad": c5.conv5_bf16_input_grad_cuda}


def every_kernel(counts: dict) -> dict:
    """``counts`` with 0 for each kernel it leaves out."""
    return {name: counts.get(name, 0) for name in kernel_counters()}


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
    per_request = every_kernel({"slot_attention": 1, "vit_attention": path.vit_per_request,
                                "conv5": path.conv5_per_request})

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


def eval_step_values(exp_path, pred_name, ckpts, num_preds, dev, init=None):
    """The framewise metrics (on the CPU) of the eval step at B=2 on ``dev``
    over the first test batch, from ``init`` initial slots (the CPU
    evaluator's initializer's with seed SEED + 5 when None), and those slots."""
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    ev = PredictorEvaluator(exp_path, pred_name, *ckpts, num_seed=1, num_preds=num_preds,
                            batch_size=2, device=dev)
    ev.load_data()
    ev.load_models()
    videos, info = next(iter(ev.test_loader))
    if init is None:
        with torch.no_grad():
            init = ev.model.slot_initializer(2, torch.Generator().manual_seed(SEED + 5)).cpu()
    vals = ev.eval_step(videos, info, initial_slots=init)
    return {m: v.cpu() for m, v in vals.items()}, init


def phase_eval_parity(exp_path, pred_name="textocvp_t5", ckpts=("random", "random"),
                      num_preds=EVAL_PREDS, phase="eval_parity"):
    """The eval step at B=2 on the card and on the CPU: the same weights
    (``ckpts``: the decomposition model's and the predictor's), initial
    slots and frames; the CPU's in the parity worker, checked at the end
    (``defer_parity``). Off the main path."""
    card, init = eval_step_values(exp_path, pred_name, ckpts, num_preds, "cuda")
    job = parity_pool().apply_async(eval_step_values,
                                    (exp_path, pred_name, ckpts, num_preds, "cpu", init))

    def finish():
        cpu, _ = job.get()
        # float32 through encode, the rollout and the decode on two devices,
        # sums in other orders: PSNR within 1e-3 dB, SSIM and LPIPS within 1e-4
        tol = {"psnr": 1e-3, "ssim": 1e-4, "lpips": 1e-4}
        errs = {}
        for m, limit in tol.items():
            out, ref = card[m], cpu[m]
            check(out.shape == (2, num_preds) and bool(torch.isfinite(out).all()),
                  f"{phase}: {m} {tuple(out.shape)} not finite or misshapen")
            errs[m] = (out - ref).abs().max().item()
            check(errs[m] <= limit, f"{phase}: framewise {m} card vs CPU {errs[m]} > {limit}")
        return {"max_abs_err": errs, "tolerance": tol,
                "cpu_framewise_mean": {m: v.mean(0).tolist() for m, v in cpu.items()}}
    defer_parity(phase, finish, B=2, num_preds=num_preds)


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
    check(counts == every_kernel({"slot_attention": batches, "conv5": 3 * batches}),
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


PARITY_CPU_THREADS = 4  # the CPU halves' torch threads, beside the card phases' host work
PARITY_POOL = []        # the worker process of the CPU halves, started at first use
PENDING_PARITIES = []   # each parity's phase line, printed once its CPU half is checked


def parity_pool():
    """One spawned worker process that runs the trainer parities' CPU halves
    in turn while the card phases go on."""
    if not PARITY_POOL:
        import multiprocessing

        PARITY_POOL.append(multiprocessing.get_context("spawn").Pool(
            1, initializer=_parity_worker_init))
    return PARITY_POOL[0]


def _parity_worker_init():
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the CPU halves never touch the card
    torch.set_num_threads(PARITY_CPU_THREADS)


def finish_parities():
    """Wait for every CPU half, check each parity and print its phase line;
    then stop the worker."""
    while PENDING_PARITIES:
        PENDING_PARITIES.pop(0)()
    if PARITY_POOL:
        pool = PARITY_POOL.pop()
        pool.close()
        pool.join()


def defer_parity(phase, finish, **line):
    """Print ``phase``'s line with ``finish()``'s report once the CPU half is in."""
    PENDING_PARITIES.append(lambda: emit({"phase": phase, **line, **finish()}))


def clip_codes(x):
    """The loss's [0, 1] clip (``train/losses.py::clip01``, ``jnp.clip``) at
    each value of ``x`` as twice its gradient's weight: 2 inside, 1 at a
    bound (the tie's half), 0 outside."""
    return (2 * ((x > 0) & (x < 1)) + ((x == 0) | (x == 1))).to(torch.uint8)


def _kink_functions(what, replayed, rec_or_rep, replay: bool):
    """The functions ``trainer_parity`` patches in for one run: with
    ``replay`` False they record each kink's mask into ``rec_or_rep`` ("main"
    in call order, "sa" one list a tracked slot-attention call); with
    ``replay`` True they take each mask from its iterators and apply those of
    ``replayed``. Returns (relu, slot_attention_plain, decoder tail conv,
    DecompTrainer._loss_tensors)."""
    from textocvp_tpu_torch.nn import decoders
    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    relu = torch.nn.functional.relu
    tail_conv, sa_plain, loss_tensors = decoders.conv5, sak.slot_attention_plain, \
        DecompTrainer._loss_tensors
    state = rec_or_rep

    def tracked(*tensors):
        return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)

    def kink(x):
        """The kind of a ReLU of ``x``, for all kinds; None off the gradient's path."""
        if not x.requires_grad:
            return None
        return ("sa_relu" if state["in_sa"] else "mlp" if state["in_mlp"]
                else "ff" if state["in_ff"] else "relu")

    if not replay:
        def relu_fn(x, inplace=False):
            kind = kink(x)
            if kind is not None:
                (state["sa"][-1] if state["in_sa"] else state["main"]).append(
                    (kind, (x.detach() > 0).cpu()))
            return relu(x, inplace=inplace)

        def sa_fn(k, v, slots, params, *args, **kwargs):
            if not tracked(k, v, slots, *params.values()):
                return sa_plain(k, v, slots, params, *args, **kwargs)
            state["sa"].append([])
            state["in_sa"] = True
            try:
                return sa_plain(k, v, slots, params, *args, **kwargs)
            finally:
                state["in_sa"] = False

        def conv_fn(x, w, b, relu=True):
            y = tail_conv(x, w, b, relu)
            if relu:
                state["main"].append(("conv5", (y.detach() > 0).cpu()))
            return y

        def loss_fn(self, out, videos):
            tensors = loss_tensors(self, out, videos)
            for key, src in CLIPPED:
                if key in tensors:
                    state["main"].append(("clip", clip_codes(out[src].detach()).cpu()))
            return tensors
        return relu_fn, sa_fn, conv_fn, loss_fn

    def take(stream, kind, shape):
        got, mask = next(stream)
        check(got == kind and mask.shape == shape,
              f"{what}: replayed {got} {tuple(mask.shape)} at a {kind} {tuple(shape)}")
        return mask

    def relu_fn(x, inplace=False):
        kind = kink(x)
        if kind is None:
            return relu(x, inplace=inplace)
        mask = take(state["call"] if state["in_sa"] else state["main"], kind, x.shape)
        return x * mask if kind in replayed else relu(x, inplace=inplace)

    def sa_fn(k, v, slots, params, *args, **kwargs):
        if not tracked(k, v, slots, *params.values()):
            return sa_plain(k, v, slots, params, *args, **kwargs)
        state["call"] = iter(next(state["sa"]))
        state["in_sa"] = True
        try:
            return sa_plain(k, v, slots, params, *args, **kwargs)
        finally:
            state["in_sa"] = False

    def conv_fn(x, w, b, relu=True):
        y = c5.conv5_plain(x, w, b, relu=False)
        if not relu:
            return y
        mask = take(state["main"], "conv5", y.shape)
        return y * mask if "conv5" in replayed else torch.relu(y)

    def loss_fn(self, out, videos):
        tensors = loss_tensors(self, out, videos)
        for key, src in CLIPPED:
            if key in tensors:
                x = out[src]
                codes = take(state["main"], "clip", x.shape)
                if "clip" in replayed:
                    w = codes.to(x.device, x.dtype) / 2
                    tensors[key] = w * x + (1 - w) * x.detach().clamp(0, 1)
        return tensors
    return relu_fn, sa_fn, conv_fn, loss_fn


def _parity_run(what, make, step, dev, replayed, state, replay, probe=None, steps=2):
    """``steps`` training steps of ``make(dev)`` with the kink functions patched in
    (``_kink_functions``): (the trainer, its losses, the gradient leaves and
    the buffers after the first step, ``probe(trainer)`` after the second);
    without ``replay`` ``state`` records the masks, and ``state["marks"]``
    where each step's slot-attention calls start."""
    from textocvp_tpu_torch.models import predictors
    from textocvp_tpu_torch.nn import blocks, decoders
    from textocvp_tpu_torch.ops import slot_attention_kernel as sak
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    F = torch.nn.functional
    relu, tail_conv, mlp_forward = F.relu, decoders.conv5, blocks.MLP.forward
    feed_forwards = {cls: cls.feed_forward for cls in (blocks.TorchStyleEncoderLayer,
                                                       predictors.OCVPParLayer)}
    sa_plain, loss_tensors = sak.slot_attention_plain, DecompTrainer._loss_tensors

    def flagged(flag, fn):
        def forward(self, x):
            state[flag] = True
            try:
                return fn(self, x)
            finally:
                state[flag] = False
        return forward

    relu_fn, sa_fn, conv_fn, loss_fn = _kink_functions(what, replayed, state, replay)
    F.relu, decoders.conv5, sak.slot_attention_plain = relu_fn, conv_fn, sa_fn
    DecompTrainer._loss_tensors = loss_fn
    blocks.MLP.forward = flagged("in_mlp", mlp_forward)
    for cls, fn in feed_forwards.items():
        cls.feed_forward = flagged("in_ff", fn)
    try:
        tr = make(dev)
        state["buffers0"] = {n: b.detach().cpu().clone() for n, b in tr.model.named_buffers()}
        losses = []
        for i in range(steps):
            if not replay:
                state["marks"].append(len(state["sa"]))
            losses.append(step(tr, dev, i))
            if i == 0:
                grads = {n: p.grad.detach().cpu()
                         for n, p in tr.model.named_parameters() if p.requires_grad}
                buffers = {n: b.detach().cpu().clone() for n, b in tr.model.named_buffers()}
    finally:
        F.relu, decoders.conv5, sak.slot_attention_plain = relu, tail_conv, sa_plain
        DecompTrainer._loss_tensors = loss_tensors
        blocks.MLP.forward = mlp_forward
        for cls, fn in feed_forwards.items():
            cls.feed_forward = fn
    return tr, losses, grads, buffers, (probe(tr) if probe is not None else None)


def _new_state():
    return {"main": [], "sa": [], "in_sa": False, "in_mlp": False, "in_ff": False, "marks": []}


def parity_cpu_half(spec_path, out_path):
    """The CPU's two runs of a trainer parity, in the parity worker: its own
    masks (unless the spec's ``own`` is False), then the card's masks
    replayed (the card's slot-attention calls of each step ran in reverse),
    each of the spec's ``steps``. Writes what ``trainer_parity`` checks and
    the seconds the half took."""
    t = time.perf_counter()
    spec = torch.load(spec_path, weights_only=False)
    what, make, step, replayed, probe = (spec[k] for k in ("what", "make", "step", "replayed",
                                                           "probe"))
    steps = spec.get("steps", 2)
    own = _new_state()
    own_losses = own_grads = None
    if spec.get("own", True):
        _, own_losses, own_grads, _, _ = _parity_run(what, make, step, "cpu", replayed, own,
                                                     False, steps=steps)
    card = spec["card"]
    bounds = card["marks"] + [len(card["sa"])]
    rep = {"in_sa": False, "in_mlp": False, "in_ff": False, "main": iter(card["main"]),
           "sa": iter([call for a, b in zip(bounds[:-1], bounds[1:])
                       for call in reversed(card["sa"][a:b])])}
    tr, losses, grads, buffers, probed = _parity_run(what, make, step, "cpu", replayed, rep, True,
                                                     probe, steps=steps)
    torch.save({"losses": losses, "grads": grads, "buffers": buffers, "probe": probed,
                "own": {"main": own["main"], "sa": own["sa"], "losses": own_losses,
                        "grads": own_grads},
                "params": [p.detach() for p in tr.optimizer.params],
                "lr": tr.lr_schedule(0), "threads": torch.get_num_threads(),
                "seconds": time.perf_counter() - t}, out_path)


def trainer_parity(what, make, step, tail_convs=6, exact_zero=(), probe=None, compare=None,
                   replayed=CATER_KINKS):
    """One trainer on the card and on the CPU from the same weights:
    ``make(dev)`` builds and sets it up on ``dev``, ``step(trainer, dev, i)``
    takes its i-th training step (i = 0, 1) and returns the loss; both
    picklable (``functools.partial`` of module-level functions). The card's
    run happens here; the CPU's two runs go to the parity worker
    (``parity_cpu_half``) while the card phases after this one run. Returns
    a function that waits for them, checks, and returns what a phase
    reports: the two losses (1e-5 relative), every trainable gradient leaf
    after the first step (1e-4 of the leaf's largest value; a leaf of
    ``exact_zero``, whose gradient is 0 in exact arithmetic, 1e-4 of the
    largest value of any leaf on both devices), the module's buffers after
    the first step (1e-5 absolute and relative: BatchNorm's running
    statistics) and the parameters after the second. ``probe(trainer)``, run
    on each device after the second step, and ``compare({device: probe})``
    may check more and return what it reports.

    The CPU runs twice. Its own run is reported. The checked one takes the
    masks of the kinks of ``replayed`` from the card's run, in call order:
    "conv5" the ReLU of each decoder-tail conv; "mlp" each ReLU of an
    ``MLP``'s hidden layer; "ff" the ReLU of a ``TorchStyleEncoderLayer``'s
    or an ``OCVPParLayer``'s feed-forward; "relu" every other ReLU
    (``torch.nn.functional.relu``) whose input requires grad; "sa_relu" each
    ReLU of the slot-attention MLP, which the card computes in the
    backward's recompute, frames in reverse, and the CPU in the forward;
    "clip" the [0, 1] clip of each reconstruction in the 02 loss (its
    gradient's weight, ``clip_codes``). A value
    within the card's rounding of a kink (conv5's 3xTF32, cuBLAS, cuDNN) may
    fall on either side of it on the two devices, and the gradient of what
    comes before it then differs by a whole term (``relu_mask_flips`` counts
    such values by kind, over the kinks of ``ALL_KINKS``), which no float32
    tolerance covers. ``tail_convs`` is the number of conv5 masks the two
    steps give."""
    card = _new_state()
    tr, card_losses, card_grads, card_buffers, card_probe = _parity_run(
        what, make, step, "cuda", replayed, card, False, probe)
    card_params = [p.detach().cpu() for p in tr.optimizer.params]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    spec_path = Path(tempfile.mkstemp(prefix="parity_spec_", suffix=".pt")[1])
    out_path = spec_path.with_name(spec_path.name.replace("spec", "cpu"))
    torch.save({"what": what, "make": make, "step": step, "replayed": replayed, "probe": probe,
                "card": {k: card[k] for k in ("main", "sa", "marks")}}, spec_path)
    job = parity_pool().apply_async(parity_cpu_half, (str(spec_path), str(out_path)))
    submitted = time.perf_counter()

    def finish():
        job.get()
        waited = time.perf_counter() - submitted
        cpu = torch.load(out_path, weights_only=False)
        for path in (spec_path, out_path):
            path.unlink()
        own = cpu["own"]
        grads = {"cuda": card_grads, "cpu": cpu["grads"], "cpu_own_masks": own["grads"]}
        losses = {"cuda": card_losses, "cpu_own_masks": own["losses"], "cpu": cpu["losses"]}
        kinds = [k for k, _ in card["main"]]
        check(kinds == [k for k, _ in own["main"]] and kinds.count("conv5") == tail_convs
              and len(card["sa"]) == len(own["sa"]),
              f"{what}: masks {len(card['main'])}, of tail convs {kinds.count('conv5')}, "
              f"slot-attention calls {len(card['sa'])} / {len(own['sa'])}")
        bounds = card["marks"] + [len(card["sa"])]
        card_sa = [m for a, b in zip(bounds[:-1], bounds[1:])
                   for call in reversed(card["sa"][a:b]) for m in call]
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
        buffer_err = {n: ((b - cpu["buffers"][n]).abs() / (1 + cpu["buffers"][n].abs())
                          ).max().item()
                      for n, b in card_buffers.items() if b.is_floating_point()}
        # Adam moves each element by about lr a step whatever its gradient's
        # size, so an element whose gradient is within rounding of 0 may move
        # either way on the two devices; every other element moves alike
        lr = cpu["lr"]
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(card_params, cpu["params"])])
        moved_apart = float((diffs > 1e-2 * lr).float().mean())
        summary = (f"losses {losses}; parameters after two steps: max diff "
                   f"{diffs.max().item()}, share apart by more than lr/100 {moved_apart} "
                   f"(lr {lr}); flips {flips}")
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
        extra = compare({"cuda": card_probe, "cpu": cpu["probe"]}) if compare else {}
        return {"losses": losses, "loss_rel_err": loss_err,
                "grad_err_over_max": dict(worst["cpu"][:8]),
                "grad_err_over_max_cpu_own_masks": dict(worst["cpu_own_masks"][:8]),
                "exact_zero_grad_over_max": zero_err,
                "buffer_max_err": max(buffer_err.values(), default=None),
                "trainable_leaves": len(names), "relu_mask_flips": flips,
                "replayed": list(replayed), "relu_mask_outputs": outputs,
                "grad_tolerance": GRAD_TOLERANCE, "params_max_abs_diff": diffs.max().item(),
                "params_share_apart_over_lr_100": moved_apart, "lr": lr, "tf32": False,
                "cpu_half": {"worker_threads": cpu["threads"], "seconds": cpu["seconds"],
                             "waited_s_after_submit": waited}, **extra}
    return finish


# ---------------------------------------------------------- bf16 training

BF16_PARITY_FRAMES = {"cater": 3, "clipport": 2}  # T of the 02 parities; 04: c=1, p=2 / 1


def with_compute_dtype(exp_path: Path, dtype: str, name: str) -> Path:
    """``exp_path``'s params again beside it as ``name``, computing in
    ``dtype`` (``tpu.compute_dtype``)."""
    from textocvp_tpu_torch.core.experiment import Experiment

    params = Experiment(exp_path).params
    params["tpu"] = {**(params.get("tpu") or {}), "compute_dtype": dtype}
    exp = Experiment(exp_path.parent / name)
    exp.save_params(params)
    return exp.exp_path


def bf16_trainer_parity(what, exp, make, step, tail_convs=0, exact_zero=(),
                        replayed=ALL_KINKS):
    """One training step of ``make(exp', dev)`` in float32 and in bf16 on the
    card (``exp'`` the twins of ``exp``, ``with_compute_dtype``), from the
    same weights, video and noise, and the bf16 one again on the CPU in the
    parity worker with every kink of ``replayed`` taken from the card's bf16
    run (``trainer_parity``'s masks, ``parity_cpu_half`` without its own-mask
    run). Returns a function that waits for the CPU half and holds the card's
    bf16 to it, the rule of the CPU tests (tests/torch_bf16.py) with
    e(a, b) = max |a - b| / max |card float32|: the loss, every trainable
    gradient leaf (a leaf of ``exact_zero``, 0 in exact arithmetic, with the
    largest leaf's max) and the moves of the floating buffers (BatchNorm's
    running statistics) within 2 e(card bf16, card float32) + 2**-8."""
    card, runs = {}, {}
    for dt in ("float32", "bfloat16"):
        runs[dt] = with_compute_dtype(exp, dt, f"{exp.name}_{dt}")
        state = card[dt] = _new_state()
        tr, losses, grads, buffers, _ = _parity_run(what, partial(make, runs[dt]), step, "cuda",
                                                     replayed, state, False, steps=1)
        state.update(losses=losses, grads=grads, buffers=buffers)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    c16, c32 = card["bfloat16"], card["float32"]
    spec_path = Path(tempfile.mkstemp(prefix="parity_spec_", suffix=".pt")[1])
    out_path = spec_path.with_name(spec_path.name.replace("spec", "cpu"))
    torch.save({"what": what, "make": partial(make, runs["bfloat16"]), "step": step,
                "replayed": replayed, "probe": None, "own": False, "steps": 1,
                "card": {k: c16[k] for k in ("main", "sa", "marks")}}, spec_path)
    job = parity_pool().apply_async(parity_cpu_half, (str(spec_path), str(out_path)))
    submitted = time.perf_counter()

    def held(got, want, ref, scale=None):
        scale = scale or ref.abs().max().item()
        base = (want - ref).abs().max().item() / scale
        d = (got - want).abs().max().item() / scale
        return {"cpu_vs_card_bf16": d, "card_bf16_vs_float32": base,
                "limit": 2 * base + BF16_STEP}

    def finish():
        job.get()
        waited = time.perf_counter() - submitted
        cpu = torch.load(out_path, weights_only=False)
        for path in (spec_path, out_path):
            path.unlink()
        kinds = [k for k, _ in c16["main"]]
        check(kinds.count("conv5") == tail_convs,
              f"{what}: {kinds.count('conv5')} tail-conv masks, want {tail_convs}")
        names = list(c32["grads"])
        top = max(c32["grads"][n].abs().max().item() for n in names)
        leaves = {n: held(cpu["grads"][n], c16["grads"][n], c32["grads"][n],
                          top if n in exact_zero else None) for n in names}
        loss = held(torch.tensor(cpu["losses"][:1]), torch.tensor(c16["losses"][:1]),
                    torch.tensor(c32["losses"][:1]))
        b0 = c16["buffers0"]
        moves = {n: held(cpu["buffers"][n] - b0[n], c16["buffers"][n] - b0[n],
                         c32["buffers"][n] - b0[n])
                 for n, b in c32["buffers"].items() if b.is_floating_point()
                 and (b - b0[n]).abs().max() > 0}
        over = {n: r for n, r in (*leaves.items(), ("loss", loss), *moves.items())
                if not r["cpu_vs_card_bf16"] <= r["limit"]}
        worst = sorted(leaves.items(), key=lambda kv: -kv[1]["cpu_vs_card_bf16"])[:6]
        check(not over, f"{what}: card bf16 vs CPU bf16 over the bf16 rule: "
                        f"{dict(list(over.items())[:6])}")
        same = [k for k, _ in c32["main"]] == kinds
        flips = {kind: sum(int((a != b).sum()) for (k, a), (_, b) in
                           zip(c16["main"], c32["main"]) if k == kind) for kind in ALL_KINKS
                 } if same else None
        return {"loss": loss, "worst_leaves": dict(worst), "trainable_leaves": len(names),
                "buffer_moves": moves, "exact_zero": list(exact_zero),
                "replayed": list(replayed), "masks_card_bf16_vs_float32_flips": flips,
                "losses": {"card_bf16": c16["losses"], "card_float32": c32["losses"],
                           "cpu_bf16": cpu["losses"]},
                "rule": "2 e(card bf16, card float32) + 2**-8, e over max |card float32|",
                "cpu_half": {"worker_threads": cpu["threads"], "seconds": cpu["seconds"],
                             "waited_s_after_submit": waited}}
    return finish


def clip_random_parent(tmp: Path) -> Path:
    """A CLIPort experiment whose ``checkpoint_epoch_final`` is a random
    ExtendedDINOSAUR at full width (``random_init_``, seed SEED): the frozen
    model of the bf16 04 parity."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.models.factory import random_init_

    exp = Experiment(clip_experiment(tmp / "clip_random", tmp / "none"))
    model = random_init_(setup_model(exp.params), torch.Generator().manual_seed(SEED))
    exp.models_dir.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), exp.checkpoint_path("checkpoint_epoch_final"))
    return exp.exp_path


def phase_bf16_parities(tmp: Path, train_exp: Path, clip_parent: Path):
    """The four bf16 trainer parities (``bf16_trainer_parity``) at full width,
    B=2: CATER 02 (T=3) and 04 (c=1, p=2, through the 02 path's SAVi),
    CLIPort 02 (T=2) and 04 (c=1, p=1, through the random ExtendedDINOSAUR
    of ``clip_parent``, ``clip_random_parent``),
    warmup off. Untimed: beside the shared card's ranks."""
    gen = torch.Generator().manual_seed(SEED + 40)
    cater_t, clip_t = BF16_PARITY_FRAMES["cater"], BF16_PARITY_FRAMES["clipport"]
    video = torch.rand((2, cater_t, CONV5_RES, CONV5_RES, 3), generator=gen)
    noise = [torch.randn((2, 8, 128), generator=gen)]
    exp = train_experiment(tmp / "bf16_train_parity", tmp / "none", batch_size=2,
                           lr_warmup=False)
    defer_parity("bf16_train_parity", bf16_trainer_parity(
        "bf16 train parity", exp, make_decomp_trainer, partial(decomp_step, video, noise),
        tail_convs=3, exact_zero=SLOT_EXACT_ZERO), B=2, T=cater_t)

    from textocvp_tpu_torch.core.experiment import Experiment

    exp = pred_experiment(train_exp, "bf16_pred_parity", PARITY_PREDS, batch_size=2, lr=1e-5,
                          lr_warmup=False)
    video = torch.rand((2, PRED_CONTEXT + PARITY_PREDS, CONV5_RES, CONV5_RES, 3), generator=gen)
    text = caption_batch(Experiment(exp).params, 2)
    defer_parity("bf16_pred_train_parity", bf16_trainer_parity(
        "bf16 predictor train parity", exp, make_predictor_trainer,
        partial(predictor_step, video, noise, text), tail_convs=3),
        B=2, num_context=PRED_CONTEXT, num_preds=PARITY_PREDS)

    video = torch.rand((2, clip_t, CLIP_RES, CLIP_RES, 3), generator=gen)
    clip_noise = [torch.randn((2, CLIP_SLOTS, CLIP_SLOT_DIM), generator=gen)]
    exp = clip_experiment(tmp / "bf16_clip_train_parity", tmp / "none", batch_size=2,
                          accum_steps=1, lr_warmup=False)
    defer_parity("bf16_clip_train_parity", bf16_trainer_parity(
        "bf16 clip train parity", exp, make_decomp_trainer,
        partial(decomp_step, video, clip_noise), exact_zero=CLIP_EXACT_ZERO + SLOT_EXACT_ZERO),
        B=2, T=clip_t)

    exp = pred_experiment(clip_parent, "bf16_clip_pred_parity", 1, batch_size=2,
                          accum_steps=1, lr=1e-5, lr_warmup=False)
    video = torch.rand((2, PRED_CONTEXT + 1, CLIP_RES, CLIP_RES, 3), generator=gen)
    text = caption_batch(Experiment(exp).params, 2, PATHS[1])
    defer_parity("bf16_clip_pred_train_parity", bf16_trainer_parity(
        "bf16 clip predictor train parity", exp, make_predictor_trainer,
        partial(predictor_step, video, clip_noise, text)),
        B=2, num_context=PRED_CONTEXT, num_preds=1)


# the bf16 step phases: (lr, updates on one batch and one noise draw), warmup
# off: the float32 sign checks' rates, the CLIPort ones over fewer steps of
# B=64 (the CLIPort losses fell at every step of the float32 checks)
BF16_STEPS = {"bf16_train_step": (4e-4, SIGN_STEPS), "bf16_pred_train_step": (1e-4, 5),
              "bf16_clip_train_step": (1e-6, 3), "bf16_clip_pred_train_step": (1e-4, 3)}


def bf16_experiment_of(exp_path: Path, phase: str) -> Path:
    """``exp_path`` again beside it as ``phase``, in bf16, at the phase's lr,
    warmup off."""
    from textocvp_tpu_torch.core.experiment import Experiment

    path = with_compute_dtype(exp_path, "bfloat16", phase)
    exp = Experiment(path)
    params = exp.params
    params["training"].update(lr=BF16_STEPS[phase][0], lr_warmup=False)
    exp.save_params(params)
    return path


def phase_bf16_step(phase, tr, batch, text, want, frames_per_step, split, weight_grads=0,
                    **extra):
    """A bf16 training phase at full width: BF16_STEPS updates of ``tr`` on
    one batch (``batch``, ``text``) and one noise draw, the phase's main path
    between a reset and a read of the launch counters. The first update is
    timed cold; its launches must be ``want`` (every other counter 0: no
    float32 conv5 or ViT attention) and ``weight_grads`` calls of conv5's
    weight gradient; the second is the steady step (ms and peak GB); the
    third runs split by ``split(noise)`` (stage ms and its loss). The losses
    must be finite and fall. Returns the phase's launches, with its calls of
    conv5's weight gradient as ``conv5_bf16_weight_grad_calls``."""
    from textocvp_tpu_torch.ops import conv5 as c5

    steps = BF16_STEPS[phase][1]
    noise = tr._noise(batch.shape[0])

    def step():
        return float(tr.train_step(batch, noise, **text)["_total"])

    reset_launches()  # the main path starts here
    calls0 = calls = c5.conv5_weight_grad.calls
    first = timed_once(step)
    per_step = launches()
    calls = c5.conv5_weight_grad.calls - calls
    check(per_step == every_kernel(want) and calls == weight_grads,
          f"{phase}: launches of a step {per_step}, weight-gradient calls {calls}; want "
          f"{every_kernel(want)}, {weight_grads}")
    torch.cuda.reset_peak_memory_stats()
    steady = timed_once(step)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    split_ms, split_loss = split(noise)
    losses = [first[0], steady[0], split_loss] + [step() for _ in range(steps - 3)]
    counts = launches()  # and ends here
    counts["conv5_bf16_weight_grad_calls"] = c5.conv5_weight_grad.calls - calls0
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"{phase}: the loss did not fall over {steps} steps on one batch: {losses}")
    emit({"phase": phase, "batch": batch.shape[0], "accum_steps": tr.accum, **extra,
          "dtype": "bfloat16", "first_step_ms": first[1], "step_ms": steady[1],
          "frames_per_s": 1e3 * frames_per_step / steady[1], "split_ms": split_ms,
          "peak_mem_gb": peak_gb, "launches_per_step": per_step,
          "weight_grad_calls_per_step": calls, "launches": counts, "lr": BF16_STEPS[phase][0],
          "steps": steps, "losses": losses})
    return counts


def decomp_split(tr, batch):
    """A 02 update split into forward, backward and optimizer (summed over
    the microbatches): (ms by stage, the loss)."""
    def split(noise):
        losses = []

        def forward_loss(sl, out):
            total = tr.forward_loss(batch[sl], noise[sl])[0]
            losses.append(float(total.detach()))
            return total

        stages = accumulated_split(tr, batch.shape[0], forward_loss)
        return stages, float(np.mean(losses))
    return split


def predictor_split(tr, batch, text):
    """A 04 update split into frozen encode, forward, backward and optimizer
    (summed over the microbatches): (ms by stage, the loss)."""
    def split(noise):
        losses = []

        def forward_loss(sl, out):
            total = tr.predict_loss(batch[sl], out.pop("slots"),
                                    **{k: t[sl] for k, t in text.items()})[0]
            losses.append(float(total.detach()))
            return total

        stages = accumulated_split(
            tr, batch.shape[0], forward_loss,
            encode=lambda sl, out: out.update(slots=tr.encode(batch[sl], noise[sl])))
        return stages, float(np.mean(losses))
    return split


def phase_bf16_train_step(train_exp: Path, videos):
    """The CATER 02 step in bf16 at B=64, T=8 (``phase_bf16_step``): per
    step 8 slot-attention calls, 3 bf16 conv5 launches forward and 3 for
    their input gradients, 3 weight-gradient calls."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(bf16_experiment_of(train_exp, "bf16_train_step"))
    tr.setup_model()
    batch = tr.to_device(videos)
    counts = phase_bf16_step("bf16_train_step", tr, batch, {},
                             {"slot_attention": TRAIN_FRAMES, "conv5_bf16": 6,
                              "conv5_bf16_input_grad": 3}, TRAIN_BATCH * TRAIN_FRAMES,
                             decomp_split(tr, batch), weight_grads=3, frames=TRAIN_FRAMES)
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_bf16_pred_train_step(parent: Path, videos, info):
    """The CATER 04 step in bf16 at B=64, c=1, p=9 through the 02 path's
    SAVi (``phase_bf16_step``): per step 10 slot-attention calls of the
    frozen encode, 3 bf16 conv5 launches forward and 3 for their input
    gradients, no weight gradient."""
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    exp = bf16_experiment_of(pred_experiment(parent, "bf16_pred_base"), "bf16_pred_train_step")
    tr = PredictorTrainer(exp, "checkpoint_epoch_final")
    tr.setup_model()
    random_predictor_(tr)
    batch, text = tr.batch_to_device(videos, info)
    counts = phase_bf16_step("bf16_pred_train_step", tr, batch, text,
                             {"slot_attention": PRED_FRAMES, "conv5_bf16": 6,
                              "conv5_bf16_input_grad": 3}, TRAIN_BATCH * PRED_PREDS,
                             predictor_split(tr, batch, text), num_context=PRED_CONTEXT,
                             num_preds=PRED_PREDS)
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_bf16_clip_train_step(clip_exp: Path, videos):
    """The CLIPort 02 step in bf16 at B=64, T=8, ``accum_steps`` 8
    (``phase_bf16_step``): per step one slot-attention call a frame of each
    microbatch and 12 bf16 ViT-attention launches a microbatch."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(bf16_experiment_of(clip_exp, "bf16_clip_train_step"))
    tr.setup_model()
    batch = tr.to_device(videos)
    counts = phase_bf16_step("bf16_clip_train_step", tr, batch, {},
                             {"slot_attention": CLIP_ACCUM * CLIP_FRAMES,
                              "vit_attention_bf16": CLIP_ACCUM * VIT_BLOCKS},
                             CLIP_TRAIN_BATCH * CLIP_FRAMES, decomp_split(tr, batch),
                             frames=CLIP_FRAMES)
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_bf16_clip_pred_train_step(parent: Path, videos, info):
    """The CLIPort 04 step in bf16 at B=64, c=1, p=9, ``accum_steps`` 8,
    through the CLIPort 02 path's ExtendedDINOSAUR (``phase_bf16_step``):
    per step 10 slot-attention calls and 12 bf16 ViT-attention launches a
    microbatch."""
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    exp = bf16_experiment_of(pred_experiment(parent, "bf16_clip_pred_base"),
                             "bf16_clip_pred_train_step")
    tr = PredictorTrainer(exp, "checkpoint_epoch_final")
    tr.setup_model()
    random_predictor_(tr)
    batch, text = tr.batch_to_device(videos, info)
    counts = phase_bf16_step("bf16_clip_pred_train_step", tr, batch, text,
                             {"slot_attention": CLIP_ACCUM * PRED_FRAMES,
                              "vit_attention_bf16": CLIP_ACCUM * VIT_BLOCKS},
                             CLIP_TRAIN_BATCH * PRED_PREDS, predictor_split(tr, batch, text),
                             num_context=PRED_CONTEXT, num_preds=PRED_PREDS)
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def make_decomp_trainer(exp, dev, keep_vit=False):
    """A DecompTrainer of ``exp`` on ``dev``, set up (its ViT state kept with
    ``keep_vit``, to hold it bit for bit after the steps)."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(exp, device=dev)
    tr.setup_model()
    if keep_vit:
        tr.vit0 = kept_vit(tr)
    return tr


def make_predictor_trainer(exp, dev):
    """A PredictorTrainer of ``exp`` over its parent's ``checkpoint_epoch_final``
    on ``dev``, set up, with its random predictor's output scaled."""
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    tr = PredictorTrainer(exp, "checkpoint_epoch_final", device=dev)
    tr.setup_model()
    random_predictor_(tr)
    return tr


def decomp_step(video, noise, tr, dev, i):
    return float(tr.train_step(video.to(dev), noise[i])["_total"])


def predictor_step(video, noise, text, tr, dev, i):
    tx = {k: v.to(dev) for k, v in text.items()}
    return float(tr.train_step(video.to(dev), noise[i], **tx)["_total"])


def phase_train_parity(tmp: Path):
    """DecompTrainer on the card and on the CPU at full width, B=2, T=3 (the
    first frame 3 iterations, the others 1), the same initial weights, video
    and slot noise, warmup off (``trainer_parity``). Off the main path."""
    exp = train_experiment(tmp / "train_parity", tmp / "none", batch_size=2, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 8)
    video = torch.rand((2, 3, CONV5_RES, CONV5_RES, 3), generator=gen)
    noise = [torch.randn((2, 8, 128), generator=gen) for _ in range(2)]
    finish = trainer_parity("train parity", partial(make_decomp_trainer, exp),
                            partial(decomp_step, video, noise))
    defer_parity("train_parity", finish, B=2, T=3)


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
    """The 02 CLI at B=64, T=8 over TRAIN_VIDEOS training videos (3 steps
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
    want = every_kernel({"slot_attention": TRAIN_FRAMES * (valid + steps + strips),
                         "conv5": 3 * (valid + strips) + 6 * steps})
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
    """SIGN_STEPS steps on one fixed batch of 8 at lr 4e-4, no warmup: the loss must
    fall. Off the main path."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(exp_path)
    tr.training_params.update(lr=4e-4, lr_warmup=False)
    tr.setup_model()
    batch = tr.to_device(videos[:8])
    losses = [float(tr.train_step(batch)["_total"]) for _ in range(SIGN_STEPS)]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"sign check: the loss did not fall over {SIGN_STEPS} steps: {losses}")
    emit({"phase": "train_sign", "batch": 8, "frames": TRAIN_FRAMES, "lr": 4e-4,
          "steps": SIGN_STEPS,
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
    """The train path: the fixture, the main path (the 02 CLI and its
    resume), the steady step, the bf16 step. Returns the main path's
    launches, its conv5 input-gradient launches, the trained experiment (its
    ``checkpoint_epoch_final.pt`` is the predictor path's frozen SAVi), the
    bf16 phase's launches, and the card-against-CPU parity and the sign
    check, which ``main`` runs beside the shared card's ranks."""
    data_root = write_cater_fixture(tmp / "CATER_train", (("train", TRAIN_VIDEOS),
                                                          ("test", TRAIN_VALID_VIDEOS)))
    exp_path = train_experiment(tmp / "train", data_root)
    gc.collect()
    torch.cuda.empty_cache()  # the eval phases' cached blocks: the step reserves afresh
    counts, input_grad, trainer = phase_train(exp_path)
    videos, _ = next(iter(trainer.train_loader))
    phase_train_step(trainer, videos)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = phase_bf16_train_step(exp_path, videos)
    untimed = [partial(phase_train_parity, tmp),
               partial(phase_train_sign, train_experiment(tmp / "train_sign", data_root), videos)]
    return counts, input_grad, exp_path, bf16, untimed


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

    exp = pred_experiment(parent, "pred_parity", PARITY_PREDS, batch_size=2, lr=1e-5,
                          lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 10)
    video = torch.rand((2, PRED_CONTEXT + PARITY_PREDS, CONV5_RES, CONV5_RES, 3), generator=gen)
    noise = [torch.randn((2, 8, 128), generator=gen) for _ in range(2)]
    text = caption_batch(Experiment(exp).params, 2)
    finish = trainer_parity("predictor train parity", partial(make_predictor_trainer, exp),
                            partial(predictor_step, video, noise, text))
    defer_parity("pred_train_parity", finish, B=2, num_context=PRED_CONTEXT,
                 num_preds=PARITY_PREDS)


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
    want = every_kernel({"slot_attention": PRED_FRAMES * (valid + steps + strips),
                         "conv5": 3 * (valid + strips) + 6 * steps})
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
    step_ms, peak_gb = steady_steps(lambda: trainer.train_step(batch, **text), reps=1,
                                    warm=False)
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
    losses = [float(tr.train_step(batch, **text)["_total"]) for _ in range(SIGN_STEPS)]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"predictor sign check: the loss did not fall over {SIGN_STEPS} steps: {losses}")
    emit({"phase": "pred_train_sign", "batch": 8, "num_preds": PRED_PREDS, "lr": 1e-4,
          "steps": SIGN_STEPS, "losses": losses})


def run_pred_train(parent: Path):
    """The predictor-train path over the 02 phase's experiment ``parent``:
    the main path (the 04 CLI, its resume and the 05 CLI on its
    checkpoint), the steady step, the bf16 step. Returns the main path's
    launches, conv5 input-gradient launches and weight-gradient calls, the
    bf16 phase's launches, and the card-against-CPU parity and the sign
    check, which ``main`` runs beside the shared card's ranks."""
    counts, input_grad, weight_grad, trainer = phase_pred_train(
        parent, pred_experiment(parent, PRED_NAME), TRAIN_VIDEOS // TRAIN_BATCH)
    videos, info = next(iter(trainer.train_loader))
    phase_pred_train_step(trainer, videos, info)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = phase_bf16_pred_train_step(parent, videos, info)
    return counts, input_grad, weight_grad, bf16, [
        partial(phase_pred_train_parity, parent),
        partial(phase_pred_train_sign, parent, videos, info)]


# ------------------------------------------------------------ the other predictors

OTHER_PREDICTORS = ("VanillaTransformer", "OCVPSeq", "OCVPPar", "TextOCVP_CustomTF")
SERVED_OTHERS = ("OCVPSeq", "TextOCVP_CustomTF")
OTHER_TRAIN_STEPS = 1  # steps of the 04 CLI's first run, after one valid batch


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
    check(rc == 0 and counts == every_kernel({"slot_attention": batches,
                                              "conv5": 3 * batches}),
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
    check(counts == every_kernel({k: len(requests) * n for k, n in per_request.items()}),
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

    exp = other_experiment(parent, name, parent / "none", "parity", PARITY_PREDS,
                           batch_size=2, lr=1e-5, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 21)
    video = torch.rand((2, PRED_CONTEXT + PARITY_PREDS, CONV5_RES, CONV5_RES, 3), generator=gen)
    noise = [torch.randn((2, 8, 128), generator=gen) for _ in range(2)]
    text = caption_batch(exp.params, 2)
    key_biases = tuple(n for n, _ in setup_predictor(exp.params).named_parameters()
                       if n.endswith(".k.bias"))
    finish = trainer_parity(f"{name} train parity", partial(make_predictor_trainer, exp.exp_path),
                            partial(predictor_step, video, noise, text), exact_zero=key_biases,
                            replayed=PREDICTOR_KINKS)
    defer_parity("predictors_train_parity", finish, predictor=name, B=2,
                 num_context=PRED_CONTEXT, num_preds=PARITY_PREDS, text_keys=sorted(text))


def run_predictors(tmp: Path, parent: Path):
    """The four other predictors through the frozen SAVi of the 02 phase's
    experiment ``parent``: for each, the rollout parity, the 05 path (the
    CLI, then a step split and profiled) over the eval phase's set, the
    service (OCVPSeq and TextOCVP_CustomTF), and the 04 path (the CLI for
    OTHER_TRAIN_STEPS steps, its resume and the 05 CLI on its checkpoint,
    then the steady step) over a set of its own. Returns each main path's
    launches, by predictor the 04 paths' conv5 input-gradient launches and
    weight-gradient calls, and the 04 parities, which ``main`` runs beside
    the shared card's ranks."""
    data_root = write_cater_fixture(tmp / "CATER_predictors", (
        ("train", OTHER_TRAIN_STEPS * TRAIN_BATCH), ("test", TRAIN_VALID_VIDEOS)))
    counts, input_grads, weight_grads, untimed = {}, {}, {}, []
    for name in OTHER_PREDICTORS:
        exp = other_experiment(parent, name, tmp / "CATER", "eval")
        torch.save(random_predictor(exp.params, torch.Generator().manual_seed(SEED + 4))
                   .state_dict(), exp.checkpoint_path("random"))
        phase_predictors_parity(name, exp)
        counts[f"predictors_eval:{name}"] = phase_predictors_eval(parent, name, exp)
        if name in SERVED_OTHERS:
            counts[f"predictors_service:{name}"] = phase_predictors_service(parent, name, exp)
        untimed.append(partial(phase_predictors_train_parity, parent, name))
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
    return counts, input_grads, weight_grads, untimed


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
    check(counts == every_kernel({k: n * batches for k, n in path.launches.items()}),
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

# The decomposition models' other encoders and decoders at the stock widths:
# SAVi with the ResNet-34 encoder (64 px frames to an 8 x 8 grid of 512
# features), and SAVi with a BatchNorm decoder that upsamples 8 -> 64 px
RESNET_ENCODER = {"encoder_name": "ResNet",
                  "encoder_params": {"resolution": [8, 8], "num_groups": 32}}
BN_UP_DECODER = {"batch_norm": True, "upsample": 2, "resolution": [8, 8]}
RESNET_STEPS = 2                        # 02 steps of the ResNet SAVi's CLI run, at B=64
RESNET_VIDEOS = RESNET_STEPS * TRAIN_BATCH
VARIANT_PARITY = (2, 2)                 # (B, T) of the card-against-CPU decompose
VARIANT_TOLERANCE = 1e-4                # of the largest |value|, slots, masks and frames
RESNET_NAME = "resnet_savi"


def variant_params(data_root=None, encoder=None, decoder=None):
    """The stock SAVi on CATER_Easy (8 slots x 128, MLP 256, the transition
    block, the 4 x 64 decoder to 64 x 64) with ``encoder`` in place of its
    encoder and ``decoder`` over its decoder's params; the 02 batch of the
    train path."""
    from textocvp_tpu_torch.core.config import build_exp_params

    params = build_exp_params("SAVi", "CATER_Easy")
    mp = params["model"]["model_params"]
    if encoder is not None:
        mp["encoder"] = json.loads(json.dumps(encoder))
    mp["decoder"]["decoder_params"].update(decoder or {})
    if data_root is not None:
        params["dataset"]["root"] = str(data_root)
    params["training"].update({"batch_size": TRAIN_BATCH, "num_epochs": 1, "log_frequency": 1})
    return params


def variant_parity(what, model, train: bool):
    """``model`` (on the CPU, random or trained weights) against a copy on the
    card, TF32 off, on the same 64 px video of VARIANT_PARITY frames with the
    same initial slots, in ``train()`` or ``eval()``: slots, masks and frames
    within VARIANT_TOLERANCE of the largest |value|. Off the main path."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, t = VARIANT_PARITY
    gen = torch.Generator().manual_seed(SEED + 60)
    video = torch.rand((b, t, CONV5_RES, CONV5_RES, 3), generator=gen)
    init = model.slot_initializer(b, gen)
    card = copy.deepcopy(model).cuda()
    outs = {}
    with torch.no_grad():
        for dev, m in (("cpu", model), ("cuda", card)):
            m.train(train)
            out = m.decompose(video.to(dev), initial_slots=init.to(dev))
            out.update(m.decoded(out["slot_history"]))
            outs[dev] = {k: out[k].cpu() for k in ("slot_history", "masks", "recons_imgs")}
    errs = {}
    for k, ref in outs["cpu"].items():
        got = outs["cuda"][k]
        check(bool(torch.isfinite(got).all()) and got.shape == ref.shape,
              f"{what}: {k} on the card not finite or misshapen")
        errs[k] = ((got - ref).abs().max() / ref.abs().max()).item()
        check(errs[k] <= VARIANT_TOLERANCE,
              f"{what}: {k} card vs CPU {errs[k]} of its largest value > {VARIANT_TOLERANCE}")
    del card
    return {"B": b, "T": t, "train_mode": train, "rel_err": errs,
            "max_abs_ref": {k: v.abs().max().item() for k, v in outs["cpu"].items()},
            "shapes": {k: list(v.shape) for k, v in outs["cpu"].items()}}


def phase_resnet_savi(tmp: Path, cater_served: Path):
    """SAVi with the ResNet encoder through the CLIs at full width: the 01
    CLI makes the experiment (its encoder then set to ``RESNET_ENCODER``),
    the 02 CLI trains RESNET_STEPS steps at B=64, T=8 after a B=64 valid
    batch, the 03 CLI evaluates one B=64 batch of its checkpoint, and a
    service answers one 8-row request through it with the CATER serving
    path's random TextOCVP_T5: the phase's main path, its launches counted
    from before the 02 CLI to after the request. Then, off it, the trained
    ResNet SAVi's ``decompose`` (``eval()``) and a random SAVi with the
    BatchNorm upsampling decoder (``train()``) on the card against the CPU.
    Returns the main path's launches."""
    import shutil

    from textocvp_tpu_torch.cli import create_experiment, evaluate_decomp, train_decomp
    from textocvp_tpu_torch.core.config import add_predictor_params
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.serve import PredictionService
    from textocvp_tpu_torch.train.checkpoints import load_params

    data_root = write_cater_fixture(tmp / "CATER_resnet", (("train", RESNET_VIDEOS),
                                                           ("test", TRAIN_BATCH)))
    exp = create_experiment.main(["-d", str(tmp / "experiments"), "--name", RESNET_NAME,
                                  "--model_name", "SAVi", "--dataset_name", "CATER_Easy"])
    params = variant_params(data_root, encoder=RESNET_ENCODER)
    exp.save_params(params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the main path starts here
    c5.conv5_input_grad_cuda.launches = 0
    t = time.perf_counter()
    trainer, out = run_cli(train_decomp.main, ["-d", str(exp.exp_path)])
    train_s = time.perf_counter() - t
    train_counts, input_grad = launches(), c5.conv5_input_grad_cuda.launches
    strips = trainer.image_strips
    want = every_kernel({"slot_attention": TRAIN_FRAMES * (1 + RESNET_STEPS + strips),
                         "conv5": 3 * (1 + strips) + 6 * RESNET_STEPS})
    check(train_counts == want and input_grad == 3 * RESNET_STEPS,
          f"{RESNET_NAME}: 02 launches {train_counts}, input-gradient {input_grad}; want {want}")
    losses = loss_lines(out)
    check(len(losses) == RESNET_STEPS and bool(np.isfinite(losses).all()),
          f"{RESNET_NAME}: 02 losses {losses}")
    ckpt = exp.checkpoint_path("checkpoint_epoch_final")
    check(ckpt.is_file(), f"{RESNET_NAME}: the 02 checkpoint was not written")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    rc = evaluate_decomp.main(["-d", str(exp.exp_path), "--decomp_ckpt", "checkpoint_epoch_final",
                               "--results_name", DECOMP_RESULTS, "--batch_size", str(TRAIN_BATCH)])
    eval_s = time.perf_counter() - t
    results = json.loads((exp.exp_path / "results" / DECOMP_RESULTS / "results.json").read_text())
    check(rc == 0 and all(len(results[m]["framewise"]) == DECOMP_FRAMES and bool(np.isfinite(
        results[m]["framewise"] + [results[m]["mean"]]).all()) for m in ("psnr", "ssim", "lpips")),
          f"{RESNET_NAME}: 03 results {results}")
    eval_counts = launches()

    pred = Experiment(exp.exp_path / "predictors" / PRED_NAME)
    pred_params = add_predictor_params(params, "TextOCVP_T5")
    pred_params["prediction_params"]["num_preds"] = PATHS[0].num_preds
    pred.save_params(pred_params)
    pred.models_dir.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(Experiment(cater_served / "predictors" / PRED_NAME).checkpoint_path("random"),
                    pred.checkpoint_path("random"))
    t = time.perf_counter()
    service = PredictionService(exp.exp_path, PRED_NAME, "checkpoint_epoch_final", "random",
                                batch_size=BATCH, max_tokens=MAX_TOKENS, device="cuda")
    rng = np.random.default_rng(SEED + 61)
    frames = rng.uniform(0, 1, (BATCH, 1, CONV5_RES, CONV5_RES, 3)).astype(np.float32)
    before = launches()
    reply = service.predict(frames, list(PATHS[0].captions[:BATCH]))
    serve_s = time.perf_counter() - t
    counts = launches()  # and ends here
    request = {k: counts[k] - before[k] for k in counts}
    check(request == every_kernel({"slot_attention": 1, "conv5": 3}),
          f"{RESNET_NAME}: a request's launches {request}")
    check(reply.shape == (BATCH, PATHS[0].num_preds, CONV5_RES, CONV5_RES, 3)
          and bool(np.isfinite(reply).all()), f"{RESNET_NAME}: reply {reply.shape}")
    check(counts["slot_attention"] > 0 and counts["conv5"] > 0,
          f"{RESNET_NAME}: launches on the main path {counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del service
    gc.collect()
    torch.cuda.empty_cache()

    model = setup_model(params)
    model.load_state_dict(load_params(ckpt))
    resnet = variant_parity(f"{RESNET_NAME} decompose", model, train=False)
    del model
    model = random_init_(setup_model(variant_params(decoder=BN_UP_DECODER)),
                         torch.Generator().manual_seed(SEED + 62))
    bn_up = variant_parity(f"{RESNET_NAME} batch-norm upsampling decoder", model, train=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": RESNET_NAME, "encoder": RESNET_ENCODER, "batch": TRAIN_BATCH,
          "frames": TRAIN_FRAMES, "train_videos": RESNET_VIDEOS, "steps": RESNET_STEPS,
          "losses": losses, "image_strips": strips, "train_cli_s": train_s,
          "eval_cli_s": eval_s, "serve_s": serve_s, "launches": counts,
          "launches_02": train_counts, "conv5_input_grad_launches": input_grad,
          "launches_03": {k: eval_counts[k] - train_counts[k] for k in counts},
          "launches_request": request, "results_03": {m: results[m]["mean"] for m in
                                                      ("psnr", "ssim", "lpips")},
          "reply_shape": list(reply.shape), "peak_mem_gb": peak_gb,
          "parity": {"resnet_eval": resnet, "bn_upsample_train": bn_up,
                     "bn_upsample_decoder": BN_UP_DECODER, "tolerance_rel": VARIANT_TOLERANCE,
                     "tf32": False}})
    return counts


# SAVi's ConvDecoder with tails off conv5's shape, at CATER's width (slots of
# 128, 64 x 64 maps, 4 layers): decoder_params over the stock ones
TAIL_DECODERS = {"k3": {"kernel_size": 3}, "k5_w32": {"num_channels": [32] * 4},
                 "k5_w128": {"num_channels": [128] * 4}, "stride2": {"stride": 2}}
TAIL_MAPS = 8  # slot maps decoded on each side: one CATER frame's slots


def phase_conv_decoder_tails() -> dict:
    """The ``ConvDecoder`` tails that conv5 does not take (a 3 x 3 tail, 5 x 5
    tails 32 and 128 wide, a stride-2 decoder) through SAVi's ``decode`` at
    CATER's width, random weights, the card against the CPU: float32 within
    VARIANT_TOLERANCE of the CPU's largest value; bf16 within 2 e(card bf16,
    card float32) + 2**-8 of the CPU's bf16 (PERF.md section 2's card rule);
    the 3 x 3 tail under int8 (``decode_quant``), each side calibrated on the
    same slots, the card's reply no farther from the CPU's than the CPU's
    int8 is from its float32. The launches of each card decode: no conv5 of
    either dtype (the tails run through ``Conv2d``), the int8 conv once a
    tail conv under int8. Returns the launches of the card's decodes."""
    import copy

    from textocvp_tpu_torch.models import setup_model
    from textocvp_tpu_torch.models.factory import random_init_
    from textocvp_tpu_torch.models.quant import calibrate_decode_scales

    params, _ = full_width_params(PATHS[0])
    slots = torch.randn((1, TAIL_MAPS, params["model"]["model_params"]["slot_dim"]),
                        generator=torch.Generator().manual_seed(SEED + 61))
    total, rows = every_kernel({}), {}

    def decode(model, x, **kw):
        reset_launches()  # each card decode's launches
        with torch.no_grad():
            out = model.decode(x, **kw)["recons_imgs"].float().cpu()
        torch.cuda.synchronize()
        counts = launches()
        for k, n in counts.items():
            total[k] += n
        return out, counts

    for case, kw in TAIL_DECODERS.items():
        t = time.perf_counter()
        out, row = {}, {"decoder_params": kw}
        for dt in ("float32", "bfloat16"):
            p = copy.deepcopy(params)
            p["model"]["model_params"]["decoder"]["decoder_params"].update(kw)
            p["tpu"] = {"compute_dtype": dt}
            cpu = random_init_(setup_model(p), torch.Generator().manual_seed(SEED + 62)).eval()
            card = copy.deepcopy(cpu).cuda()
            check(not any(card.image_decoder.on_conv5), f"conv_decoder_tails {case}: on conv5")
            with torch.no_grad():
                ref = cpu.decode(slots)["recons_imgs"].float()
            got, counts = decode(card, slots.cuda())
            check(counts == every_kernel({}), f"conv_decoder_tails {case} {dt}: launches {counts}")
            out[dt] = (got, ref)
            if case == "k3" and dt == "float32":
                with torch.no_grad():
                    q_ref = cpu.decode(slots, quant_scales=calibrate_decode_scales(cpu, slots))
                q_got, counts = decode(card, slots.cuda(),
                                       quant_scales=calibrate_decode_scales(card, slots.cuda()))
                tail = len(card.image_decoder.blocks) - 1
                check(counts == every_kernel({"conv_int8": tail}),
                      f"conv_decoder_tails k3 int8: launches {counts}")
                q_ref = q_ref["recons_imgs"]
                row["int8"] = {"max_abs_err": max_abs_diff(q_got, q_ref),
                               "int8_error_of_cpu": max_abs_diff(q_ref, ref)}
                check(row["int8"]["max_abs_err"] <= row["int8"]["int8_error_of_cpu"],
                      f"conv_decoder_tails k3 int8: {row['int8']}")
            del cpu, card
        (g32, r32), (g16, r16) = out["float32"], out["bfloat16"]
        row["float32_rel_err"] = max_abs_diff(g32, r32) / float(r32.abs().max())
        check(row["float32_rel_err"] <= VARIANT_TOLERANCE,
              f"conv_decoder_tails {case}: float32 card against CPU {row}")
        row["bf16"] = {"card_vs_cpu": e_max(g16, r16, r32),
                       "card_bf16_vs_f32": e_max(g16, g32, g32)}
        check(row["bf16"]["card_vs_cpu"] <= 2 * row["bf16"]["card_bf16_vs_f32"] + BF16_STEP,
              f"conv_decoder_tails {case}: bf16 card against CPU {row['bf16']}")
        row["shape"], row["seconds"] = list(g32.shape), time.perf_counter() - t
        rows[case] = row
    emit({"phase": "conv_decoder_tails", "maps": TAIL_MAPS, "res": CONV5_RES,
          "tolerance_float32": VARIANT_TOLERANCE,
          "tolerance_bf16": "2 e(card bf16, card float32) + 2**-8", "cases": rows,
          "launches": total})
    gc.collect()
    torch.cuda.empty_cache()
    return total


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


def vit_unchanged(tr) -> bool:
    """The trainer's ViT equals, bit for bit, the state ``make_decomp_trainer`` kept."""
    now = kept_vit(tr)
    return all(torch.equal(now[k], v) for k, v in tr.vit0.items())


def frozen_digest(tr) -> dict:
    """A SHA-256 of each tensor of the trainer's frozen decomposition model."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for k, v in tr.decomp_model.state_dict().items()}


def phase_clip_train_parity(tmp: Path):
    """DecompTrainer on ExtendedDINOSAUR on the card and on the CPU at full
    width, B=2, T=3, the same initial weights, video and slot noise, warmup
    off (``trainer_parity``: the ReLUs of the projection MLP, the
    transition, the slot-attention MLP, the patch decoder's dense stack and
    the CNN head, and the loss's clips, replayed from the card); the
    BatchNorm statistics after the first step and the ViT bit for bit after
    two. Off the main path."""
    exp = clip_experiment(tmp / "clip_train_parity", tmp / "none", batch_size=2,
                          accum_steps=1, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 21)
    video = torch.rand((2, 3, CLIP_RES, CLIP_RES, 3), generator=gen)
    noise = [torch.randn((2, CLIP_SLOTS, CLIP_SLOT_DIM), generator=gen) for _ in range(2)]

    def compare(probes):
        check(all(probes.values()), f"clip train parity: the ViT moved: {probes}")
        return {"vit_unchanged": True}

    finish = trainer_parity("clip train parity", partial(make_decomp_trainer, exp, keep_vit=True),
                            partial(decomp_step, video, noise), tail_convs=0,
                            exact_zero=CLIP_EXACT_ZERO, probe=vit_unchanged, compare=compare,
                            replayed=ALL_KINKS)
    defer_parity("clip_train_parity", finish, B=2, T=3)


def phase_clip_train(exp_path):
    """The 02 CLI on ExtendedDINOSAUR at B=64, T=8, ``accum_steps`` 8, over
    the CLIPort set (one epoch of one step after one B=16 valid batch): the
    CLIPort train path's main path. Then a second run resumes from
    ``checkpoint_last_saved`` for a second epoch. Returns the main path's
    launches and the resumed trainer."""
    from textocvp_tpu_torch.cli import train_decomp
    from textocvp_tpu_torch.core.experiment import Experiment

    epochs = 1
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
    want = every_kernel({"slot_attention": calls * CLIP_FRAMES,
                         "vit_attention": calls * VIT_BLOCKS})
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
    for name in ("checkpoint_last_saved.pt", f"checkpoint_epoch_{epochs}.pt",
                 "checkpoint_epoch_final.pt"):
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
    values = [tr.train_step(batch, noise) for _ in range(CLIP_SIGN_STEPS)]
    losses = [float(v["_total"]) for v in values]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"clip sign check: the loss did not fall over 10 steps: {losses}")
    emit({"phase": "clip_train_sign", "batch": 8, "frames": CLIP_FRAMES, "lr": 1e-6,
          "steps": CLIP_SIGN_STEPS, "losses": losses,
          "parts": {k: [float(v[k]) for v in values] for k in values[0] if k != "_total"}})


def phase_clip_pred_train_parity(parent: Path):
    """PredictorTrainer on the card and on the CPU at full width, B=2, c=1,
    p=PARITY_PREDS, through the frozen ExtendedDINOSAUR of ``parent``'s
    ``checkpoint_epoch_final`` (its BatchNorm in ``eval()``; ``main`` hands
    it ``clip_random_parent``'s, which it has before the CLIPort 02 CLI has
    trained one), the same
    predictor weights, video, captions and slot noise, warmup off, lr 1e-5
    (``trainer_parity``: the predictor's MLPs and the frozen decoder's ReLUs
    replayed from the card). Off the main path."""
    from textocvp_tpu_torch.core.experiment import Experiment

    exp = pred_experiment(parent, "clip_pred_parity", PARITY_PREDS, batch_size=2,
                          accum_steps=1, lr=1e-5, lr_warmup=False)
    gen = torch.Generator().manual_seed(SEED + 22)
    video = torch.rand((2, PRED_CONTEXT + PARITY_PREDS, CLIP_RES, CLIP_RES, 3), generator=gen)
    noise = [torch.randn((2, CLIP_SLOTS, CLIP_SLOT_DIM), generator=gen) for _ in range(2)]
    text = caption_batch(Experiment(exp).params, 2, PATHS[1])

    def compare(probes):
        check(probes["cuda"] == probes["cpu"],
              "clip predictor parity: the frozen model differs between the devices")
        return {"frozen_model_unchanged": True}

    finish = trainer_parity("clip predictor train parity", partial(make_predictor_trainer, exp),
                            partial(predictor_step, video, noise, text), tail_convs=0,
                            probe=frozen_digest, compare=compare, replayed=ALL_KINKS)
    defer_parity("clip_pred_train_parity", finish, B=2, num_context=PRED_CONTEXT,
                 num_preds=PARITY_PREDS)


def phase_clip_pred_train(parent: Path):
    """The 04 CLI at B=64, c=1, p=9, ``accum_steps`` 8, through the frozen
    ExtendedDINOSAUR that ``phase_clip_train`` wrote (one step after one
    B=16 valid batch): the CLIPort predictor path's main path. Then a second
    run resumes from ``checkpoint_last_saved`` for a second epoch: the one
    resume under ``accum_steps`` 8 (its global step and optimizer count).
    Returns the main path's launches and the resumed trainer."""
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
    want = every_kernel({"slot_attention": calls * PRED_FRAMES,
                         "vit_attention": calls * VIT_BLOCKS})
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
    """CLIP_SIGN_STEPS predictor steps on one fixed batch of 8 (no accumulation) at lr
    1e-4, no warmup, the output projection scaled (``random_predictor_``):
    the loss must fall. Off the main path."""
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    tr = PredictorTrainer(pred_experiment(parent, "clip_pred_sign", batch_size=8,
                                          accum_steps=1, lr=1e-4, lr_warmup=False),
                          "checkpoint_epoch_final")
    tr.setup_model()
    random_predictor_(tr)
    batch, text = tr.batch_to_device(videos[:8], rows(info, 8))
    losses = [float(tr.train_step(batch, **text)["_total"]) for _ in range(CLIP_SIGN_STEPS)]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"clip predictor sign check: the loss did not fall over 10 steps: {losses}")
    emit({"phase": "clip_pred_train_sign", "batch": 8, "num_preds": PRED_PREDS, "lr": 1e-4,
          "steps": CLIP_SIGN_STEPS, "losses": losses})


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
    check(counts == every_kernel({"slot_attention": batches,
                                  "vit_attention": VIT_BLOCKS * batches}),
          f"clip_eval: kernel launches on the main path: {counts}")
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


def clip_fixture(tmp: Path):
    """The CLIPort chain's start, which times nothing: the 02 parity's card
    half and the 02 experiment over the fixture that ``write_fixtures``
    wrote -> (data root, experiment)."""
    data_root = tmp / "CLIPort"
    phase_clip_train_parity(tmp)
    return data_root, clip_experiment(tmp / "clip_train", data_root, num_epochs=1)


FIXTURES_CMD = "import sys, chip_smoke; chip_smoke.write_fixtures(*sys.argv[1:])"


def write_fixtures(tmp, which):
    """Under ``tmp``: the CLIPort color-cache set (``which`` "cliport") or
    the two PNG sets ("png"), which the CLIPort chain and the PNG routes
    read (host work only)."""
    tmp = Path(tmp)
    if which == "cliport":
        write_cliport_fixture(tmp / "CLIPort")
    else:
        write_cater_png_fixture(tmp / "CATER_png")
        write_cliport_png_fixture(tmp / "CLIPort_png")


def start_fixtures(tmp: Path) -> dict:
    """``write_fixtures`` in two processes of their own, started before the
    build and the kernel rows (timed on the card's clock), long before the
    phases that read them."""
    procs = {}
    for which in ("cliport", "png"):
        log = open(tmp / f"fixtures_{which}.log", "w")
        procs[which] = (subprocess.Popen([sys.executable, "-c", FIXTURES_CMD, str(tmp), which],
                                         cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log)
    return {"procs": procs, "started": time.perf_counter(), "tmp": tmp}


def finish_fixtures(fixtures: dict) -> dict:
    """Wait for the fixture processes (before ``host_io``, whose host rates
    they would share the cores with): their seconds and the main
    timeline's wait."""
    t = time.perf_counter()
    seconds = {}
    for which, (proc, log) in fixtures["procs"].items():
        rc = proc.wait(timeout=900)
        log.close()
        seconds[which] = time.perf_counter() - fixtures["started"]
        check(rc == 0, f"the {which} fixture process failed:\n"
              + (fixtures["tmp"] / f"fixtures_{which}.log").read_text()[-3000:])
    return {"fixtures_s": seconds, "main_timeline_wait_s": time.perf_counter() - t}


def stop_fixtures(fixtures: dict):
    """Kill the fixture processes still running (a failed phase before
    ``finish_fixtures``), so that none writes on after the run."""
    for proc, log in fixtures["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def run_clip(tmp: Path, created: Path, data_root: Path, exp: Path):
    """The CLIPort chain after :func:`clip_fixture`: the 02 path (the CLI and
    its resume, the steady step, the sign check, the bf16 step); the 04 path
    over the 02 checkpoint (the same; its parity runs beside the shared
    card's ranks, through a random ExtendedDINOSAUR); the 05 path over the 04 checkpoint
    (parity, the CLI, the stage split and profile); the 03 path over the 02
    checkpoint, dropped into ``created`` (the 01 CLI's experiment). Returns
    each path's main-path launches."""
    counts = {}
    counts["clip_train"], trainer = phase_clip_train(exp)
    videos, _ = next(iter(trainer.train_loader))
    phase_clip_train_step(trainer, videos)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_clip_train_sign(data_root, tmp, videos)
    counts["bf16_clip_train_step"] = phase_bf16_clip_train_step(exp, videos)
    del videos
    counts["clip_pred_train"], trainer = phase_clip_pred_train(exp)
    videos, info = next(iter(trainer.train_loader))
    phase_clip_pred_train_step(trainer, videos, info)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    phase_clip_pred_train_sign(exp, videos, info)
    counts["bf16_clip_pred_train_step"] = phase_bf16_clip_pred_train_step(exp, videos, info)
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


def phase_host_io(tmp: Path, fixtures=None):
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
          "host_cpus": os.cpu_count(), "decode_resize": rates, "fixture_process": fixtures})


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
    PNG set ``png_root`` on the card, a PNG route's main path; the ``.npy``
    caches that ``cli/make_npy_cache.py`` builds from it (args
    ``cache_args``) hold the same items bit for bit, so the cache route's
    05 gives the same ``results.json`` (its CLI run, the same path as the
    ``eval`` phase's, was cut to keep the run inside its time limit). Then,
    on the CLI's own evaluator (kept, not built again), the loader's
    frames/s on the PNG set against the eval step's demand, and the device's
    idle share of the loader's batch and its step under ``torch.profiler``.
    Returns the main path's launches."""
    from concurrent.futures import ThreadPoolExecutor

    from textocvp_tpu_torch.cli import evaluate_predictor, make_npy_cache
    from textocvp_tpu_torch.data.loader import load_data
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    cache_root = png_root.with_name(png_root.name + "_npy")
    t = time.perf_counter()
    make_npy_cache.main([*cache_args, "--root", str(png_root), "--out", str(cache_root)])
    cache_s = time.perf_counter() - t
    params, pred_params = full_width_params(path)
    results, exps, cli_s = {}, {}, {}
    for route, root in (("png", png_root),):
        for p in (params, pred_params):
            p["dataset"]["root"] = str(root)
        exps[route] = write_experiment(tmp / f"{phase}_{route}", params, pred_params)
        argv = ["-d", str(exps[route]), "--name_pred_exp", "textocvp_t5", "--decomp_ckpt",
                "random", "--pred_ckpt", "random", "--batch_size", str(batch), "--num_seed",
                "1", "--num_preds", str(path.num_preds)]
        evaluators = []
        evaluate = PredictorEvaluator.evaluate

        def keep(self, *a, **kw):  # the CLI's evaluator, kept for the measurements below
            evaluators.append(self)
            return evaluate(self, *a, **kw)

        PredictorEvaluator.evaluate = keep
        try:
            reset_launches()  # the main path starts here
            t = time.perf_counter()
            rc = evaluate_predictor.main(argv)
            torch.cuda.synchronize()
            cli_s[route] = time.perf_counter() - t
            counts = launches()  # and ends here
        finally:
            PredictorEvaluator.evaluate = evaluate
        check(rc == 0, f"{phase} {route}: evaluate_predictor returned {rc}")
        with open(exps[route] / "predictors" / "textocvp_t5" / "results" / (
                f"eval_pred_random_NumSeed=1_NumPreds={path.num_preds}") / "results.json") as f:
            results[route] = json.load(f)
    check(counts == every_kernel(want_launches),
          f"{phase}: kernel launches on the main path {counts}, want {want_launches}")
    for m in ("psnr", "ssim", "lpips"):
        check(len(results["png"][m]["framewise"]) == path.num_preds
              and bool(np.isfinite(results["png"][m]["framewise"]).all()),
              f"{phase}: {m} {results['png'][m]}")

    (ev,) = evaluators
    # the items themselves, bit for bit (each item's PNGs decoded on a thread of its own)
    cached = load_data({**ev.exp_params, "dataset": {**ev.exp_params["dataset"],
                                                     "root": str(cache_root)}}, "test")
    check(len(cached) == len(ev.test_set), f"{phase}: {len(cached)} cached items")
    with ThreadPoolExecutor(HOST_THREADS) as pool:
        same = list(pool.map(lambda i: np.array_equal(ev.test_set[i][0], cached[i][0]),
                             range(len(cached))))
    for i, equal in enumerate(same):
        check(equal, f"{phase}: item {i} of the PNG route differs from the cache's")
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
          "items_equal_to_cache_route": True,
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


def run_png_eval(tmp: Path, root: Path):
    """The CATER 05 over frame directories of PNGs (``png_eval``) in ``root``,
    written by ``write_cater_png_fixture``."""
    return png_route_eval(tmp, "png_eval", PATHS[0], root,
                          ["--dataset", "cater", "--mode", "easy", "--split", "test",
                           "--img-size", f"{PATHS[0].res}x{PATHS[0].res}",
                           "--num-frames", str(1 + EVAL_PREDS)],
                          EVAL_BATCH, {"slot_attention": 1, "vit_attention": 0, "conv5": 3})


def run_clip_png_eval(tmp: Path, root: Path):
    """The CLIPort 05 over PNG episodes without a cache (``clip_png_eval``) in
    ``root``, written by ``write_cliport_png_fixture``."""
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
    """``make()``'s trainer without and with ``tpu.remat`` (its ``remat``,
    which the trainer reads at each forward) on one batch (``batch(trainer)``
    -> (videos, noise, text)): the gradients of a first backward of each, at
    the same parameters, then ``reps`` steady steps (backward and Adam) of
    each on the host clock, their peak GB. Returns the rows and the largest
    gradient difference over the largest leaf (checked by the caller, after
    it has printed it)."""
    rows, grads = {}, {}
    tr = make()
    videos, noise, text = batch(tr)
    for knob in (False, True):
        tr.remat = knob
        tr.backward(videos, noise, **text)
        grads[knob] = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
                       if p.grad is not None}

    def step():
        tr.backward(videos, noise, **text)
        tr.optimizer.step()

    for knob in (False, True):
        tr.remat = knob
        gc.collect()
        torch.cuda.empty_cache()
        step_ms, peak_gb = steady_steps(step, reps, warm=False)  # the backwards above warmed
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
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer
    from textocvp_tpu_torch.train.trainer import REMAT_REGIONS, DecompTrainer

    decomp = train_experiment(train_exp.parent / "remat_02", data_root)

    def noise(tr, b):  # one draw for both knobs
        return tr._noise(b, torch.Generator().manual_seed(SEED + 6))

    def make02():
        tr = DecompTrainer(decomp)
        tr.setup_model()
        return tr

    def batch02(tr):
        tr.load_data()
        videos, _ = next(iter(tr.train_loader))
        return tr.to_device(videos), noise(tr, videos.shape[0]), {}

    rows02, rel02 = remat_rows(make02, batch02)

    def make04():
        tr = PredictorTrainer(pred_experiment(train_exp, "remat_04"), "checkpoint_epoch_final")
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
    tr = DecompTrainer(clip_experiment(parent.parent / "clip_remat_02", data_root))
    tr.setup_model()
    tr.load_data()
    batch = tr.to_device(next(iter(tr.train_loader))[0][:mb])
    noise = tr._noise(mb, torch.Generator().manual_seed(SEED + 6))

    def micro():
        tr.optimizer.zero_grad()
        tr.forward_loss(batch, noise)[0].backward()

    for knob in (False, True):  # ``remat``, which the trainer reads at each forward
        tr.remat = knob
        micro()
        grads[knob] = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
                       if p.grad is not None}
        tr.optimizer.zero_grad()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = tr.forward_loss(batch, noise)[0]
        torch.cuda.synchronize()
        kept_gb = (torch.cuda.memory_allocated() - before) / 2**30
        loss.backward()
        del loss
        step_ms, peak_gb = steady_steps(micro, reps=1, warm=False)  # warmed by the passes above
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
    48.07 GB without remat, PERF.md §5): its first (cold) forward and
    backward on the host clock and its peak GB; and of CLIP_REMAT_MICROBATCH
    (``accum_steps`` 4): its peak GB from one cold call, or the card's
    refusal of the memory.
    Off the main paths."""
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
    configured = CLIP_TRAIN_BATCH // CLIP_ACCUM
    for mb in (configured, CLIP_REMAT_MICROBATCH):
        batch, text = tr.batch_to_device(videos[:mb], rows(info, mb))
        noise = tr._noise(mb)

        def micro():
            tr.optimizer.zero_grad()
            tr.forward_loss(batch, noise, **text)[0].backward()

        row = {"microbatch": mb, "accum_steps": CLIP_TRAIN_BATCH // mb}
        try:  # one cold call each: the configured one timed, the second's peak its point
            step_ms, peak_gb = steady_steps(micro, reps=1, warm=False)
            row.update(fits=True, peak_mem_gb=peak_gb,
                       **({"cold_step_ms": step_ms} if mb == configured else {}))
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

FIG_SEQS = 1           # 06 sequences on CATER (the CLIs' --num_seqs)
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
    check(counts == every_kernel({k: n * sequences for k, n in want.items()}),
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


def bf16_figs_experiment(train_exp: Path, root: Path) -> Path:
    """The 02 phase's SAVi experiment and its PRED_NAME predictor again under
    ``root``, computing in bf16, their checkpoints linked."""
    from textocvp_tpu_torch.core.experiment import Experiment

    ckpt = "checkpoint_epoch_final"
    for src, dst in ((train_exp, root),
                     (train_exp / "predictors" / PRED_NAME, root / "predictors" / PRED_NAME)):
        params = Experiment(src).params
        params["tpu"] = {**(params.get("tpu") or {}), "compute_dtype": "bfloat16"}
        Experiment(dst).save_params(params)
        Experiment(dst).models_dir.mkdir(parents=True, exist_ok=True)
        os.symlink(Experiment(src).checkpoint_path(ckpt), Experiment(dst).checkpoint_path(ckpt))
    return root


def run_figs(train_exp: Path, tmp: Path):
    """The 06 paths on CATER over the 02 phase's SAVi and the 04 phase's
    TextOCVP_T5: the card-against-CPU sequence, then the two CLIs, in float32
    and (one sequence each) in bf16, whose launches are the bf16 conv5's.
    Returns their main paths' launches."""
    phase_figs_parity(train_exp)
    gc.collect()
    counts = phase_figs_06("figs", train_exp, PRED_NAME, EVAL_PREDS, FIG_SEQS, 8, CONV5_RES,
                           CONV5_RES, {"slot_attention": DECOMP_FRAMES, "vit_attention": 0,
                                       "conv5": 3},
                           {"slot_attention": 1, "vit_attention": 0, "conv5": 6})
    counts.update(phase_figs_06("bf16_figs", bf16_figs_experiment(train_exp, tmp / "figs_bf16"),
                                PRED_NAME, EVAL_PREDS, 1, 8, CONV5_RES, CONV5_RES,
                                {"slot_attention": DECOMP_FRAMES, "conv5_bf16": 3},
                                {"slot_attention": 1, "conv5_bf16": 6}))
    return counts


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
    check(counts == every_kernel({"slot_attention": batches, "conv5": 3 * batches}),
          f"serve_batching: kernel launches on the main path {counts}, {batches} batches")
    emit({"phase": "serve_batching", "path": path.name, "batch": BATCH,
          "coalesced_equals_direct": True, "runs": runs, "launches": counts})
    del service
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------ int8 (tpu.decode_quant / encode_quant)

INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
CONV_INT8_KERNEL = "conv_int8_kernel"  # csrc/conv_int8.cu
# the decode stage's frames in a CLIPort request (B=8) and a 05 batch (B=16)
CLIP_DECODE_FRAMES = {BATCH: BATCH * CLIP_PREDS, CLIP_EVAL_BATCH: CLIP_EVAL_BATCH * CLIP_PREDS}


def cnn_head_layers():
    """(grid, Cin, Cout) of each ExtendedDINOSAUR CNN-head conv at full width
    (``MLPPatchDecoder.cnn_plan`` of ``configs/models/ExtendedDINOSAUR.json``:
    hidden 1024, a 24 x 24 patch grid, 336 px)."""
    from textocvp_tpu_torch.core.config import build_exp_params
    from textocvp_tpu_torch.nn.decoders import MLPPatchDecoder

    mp = build_exp_params("ExtendedDINOSAUR", "CLIPort")["model"]["model_params"]
    dp = {**mp["decoder"]["decoder_params"], "img_size": mp["img_size"]}
    dec = MLPPatchDecoder(**{**dp, "reconstruct_images": False})
    layers, grid, cin = [], dec.grid, dp["out_dim"] - 1
    for cout, grow in dec.cnn_plan():
        layers.append((grid, cin, cout))
        grid, cin = grid * (2 if grow else 1), cout
    return layers


def conv_int8_bounds(n, h, w, k, cin, cout):
    """int8 x read once, float32 out written once, int8 weights, scales and
    bias read once; 2 operations a product at the int8 tensor-core rate."""
    nbytes = n * h * w * cin + 4 * n * h * w * cout + k * k * cin * cout + 8 * cout + 4
    return bound(nbytes, 2 * n * h * w * k * k * cin * cout, INT8_OPS_PER_S)


def conv_int8_rows():
    """The int8 conv against its plain version, exactly, over every frame
    (the plain version in chunks of about 2 GB of float64), at SAVi's tail
    (k=5, 64 -> 64 at 64 x 64; N=1216 a request, 9728 a 05 batch) and at each
    CNN-head layer of a CLIPort request's and a 05 batch's decode (k=3).
    Beside its time: the float path it replaces on the same shapes, conv5
    (SAVi; and conv5's bf16 kernel, the opt-in bf16 decode's conv) and
    cuDNN's float32 conv + bias + ReLU (TF32 off), and the plain version's
    time over all frames. No single PyTorch call computes an int8
    convolution on CUDA: ``library_ms`` is None."""
    import torch.nn.functional as F

    from textocvp_tpu_torch.ops import conv5 as c5
    from textocvp_tpu_torch.ops import conv_int8 as ci

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(SEED + 30)
    cases = [("savi_request", BATCH * EVAL_PREDS * 8, CONV5_RES, 5, CONV5_CH, CONV5_CH, 10),
             ("savi_eval", EVAL_BATCH * EVAL_PREDS * 8, CONV5_RES, 5, CONV5_CH, CONV5_CH, 2)]
    for b, frames in CLIP_DECODE_FRAMES.items():
        cases += [(f"clipport_b{b}_cnn{i}", frames, grid, 3, cin, cout, 5)
                  for i, (grid, cin, cout) in enumerate(cnn_head_layers())]
    rows = []
    for name, n, res, k, cin, cout, reps in cases:
        x_q = torch.randint(-127, 128, (n, res, res, cin), dtype=torch.int8, device="cuda",
                            generator=gen)
        w_q = torch.randint(-127, 128, (k, k, cin, cout), dtype=torch.int8, device="cuda",
                            generator=gen)
        a_scale = torch.tensor(0.02, device="cuda")
        w_scale = 1e-4 + 1e-3 * torch.rand(cout, device="cuda", generator=gen)
        bias = torch.randn(cout, device="cuda", generator=gen)
        args = (x_q, w_q, a_scale, w_scale, bias)
        chunk = max(1, (2 << 30) // (8 * res * res * max(cin, cout)))
        launches = ci.conv_int8_cuda.launches
        out = ci.conv_int8_cuda(*args, relu=True)
        # the check's pass over every frame is the plain version's time too
        err, plain_ms = 0.0, 0.0
        for i in range(0, n, chunk):
            ref, chunk_ms = timed_once(
                lambda: ci.conv_int8_plain(x_q[i:i + chunk], *args[1:], relu=True))
            plain_ms += chunk_ms
            err = max(err, (out[i:i + chunk] - ref).abs().max().item())
            del ref
        finite = bool(torch.isfinite(out).all())
        del out
        torch.cuda.empty_cache()
        check(finite and err == 0, f"conv_int8 vs plain at {name}: {err} != 0")
        ms = cuda_ms(lambda: ci.conv_int8_cuda(*args, relu=True), reps=reps, warmup=1)
        launches = ci.conv_int8_cuda.launches - launches
        # the float path of the same shape: float activations, the conv + bias + ReLU
        x = x_q.float().mul_(0.02)
        del x_q
        w = torch.randn((k, k, cin, cout), device="cuda", generator=gen) / (k * k * cin) ** 0.5
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        lib_cl = cuda_ms(
            lambda: F.relu_(F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, padding=k // 2)),
            reps=reps, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        lib_nchw = cuda_ms(lambda: F.relu_(F.conv2d(x_nchw, w_oihw, bias, padding=k // 2)),
                           reps=reps, warmup=1)
        del x_nchw
        torch.cuda.empty_cache()
        float_path = {"cudnn_fp32_ms": min(lib_cl, lib_nchw),
                      "cudnn_fp32_layout": "nchw" if lib_nchw <= lib_cl else "channels_last"}
        if k == 5:
            float_path["conv5_ms"] = cuda_ms(lambda: c5.conv5_cuda(x, w, bias), reps=reps,
                                             warmup=1)
            # the opt-in bf16 decode's conv on the same shape
            xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
            float_path["conv5_bf16_ms"] = cuda_ms(lambda: c5.conv5_bf16_cuda(xb, wb, bias, True),
                                                  reps=reps, warmup=1)
            del xb, wb
        del x, w, w_oihw
        torch.cuda.empty_cache()
        bound_ms, bound_by = conv_int8_bounds(n, res, res, k, cin, cout)
        rows.append({"case": name, "N": n, "H": res, "W": res, "k": k, "Cin": cin, "Cout": cout,
                     "max_abs_err": err, "err_frames": "all", "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "float_path": float_path, "launches": launches, "reps": reps})
    return rows


def quant_experiment(exp_path: Path, pred_name: str, new_name: str, ckpt: str, **modes) -> str:
    """A copy of the predictor experiment ``pred_name`` of ``exp_path`` named
    ``new_name``, with ``tpu`` set to ``modes`` and its checkpoint ``ckpt``
    linked in. Returns the name."""
    from textocvp_tpu_torch.core.experiment import Experiment

    src = Experiment(exp_path / "predictors" / pred_name)
    params = src.params
    params["tpu"] = {**(params.get("tpu") or {}), **modes}
    dst = Experiment(exp_path / "predictors" / new_name)
    dst.save_params(params)
    dst.models_dir.mkdir(parents=True, exist_ok=True)
    os.symlink(src.checkpoint_path(ckpt), dst.checkpoint_path(ckpt))
    return new_name


def decode_stage_ms(exp_path, pred_name, ckpts, batch, num_preds) -> dict:
    """The 05 decode stage of one batch of the int8 experiment ``pred_name``
    on the host clock with synchronize (a warm call first), int8 after its
    calibration and then float with the same evaluator's int8 decode off,
    on the same predicted slots: {"int8": ms, "float32": ms}."""
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    ev = PredictorEvaluator(exp_path, pred_name, *ckpts, num_seed=1, num_preds=num_preds,
                            batch_size=batch)
    ev.load_data()
    ev.load_models()
    videos, info = next(iter(ev.test_loader))
    v, text = ev.to_device(videos, info)
    slots = ev.predict_stage(v, text)
    out = {}
    for key in ("int8", "float32"):
        if key == "float32":
            ev._quant_mode = None  # the float decode of the same slots
        ev.decode_stage(slots)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev.decode_stage(slots)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        out[key] = min(times)
    del ev, v, slots
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_quant_eval(phase, exp_path, pred_name, float_results: dict, ckpts, batch, num_preds,
                     batches, want_launches: dict, **modes):
    """The 05 CLI on a copy of ``pred_name`` with ``tpu`` ``modes``: the main
    path of the int8 eval (its launches, int8 included), ``results.json``'s
    honesty flags, each metric's mean against ``float_results`` (the float
    CLI's on the same weights, videos and generator seed), and the decode
    stage's ms int8 against float32. Returns the launches."""
    from textocvp_tpu_torch.cli import evaluate_predictor

    name = quant_experiment(exp_path, pred_name, f"{pred_name}_int8", ckpts[1], **modes)
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    rc = evaluate_predictor.main(["-d", str(exp_path), "--name_pred_exp", name,
                                  "--decomp_ckpt", ckpts[0], "--pred_ckpt", ckpts[1],
                                  "--batch_size", str(batch), "--num_seed", "1",
                                  "--num_preds", str(num_preds)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    check(rc == 0, f"{phase}: evaluate_predictor returned {rc}")
    want = every_kernel(want_launches)
    check(counts == want, f"{phase}: kernel launches on the main path {counts}, want {want}")
    results_path = (exp_path / "predictors" / name / "results"
                    / f"eval_pred_{ckpts[1]}_NumSeed=1_NumPreds={num_preds}" / "results.json")
    with open(results_path) as f:
        results = json.load(f)
    flags = {k: results.get(k) for k in ("decode_quant", "encode_quant")}
    check(flags == {k: modes.get(k) for k in flags}, f"{phase}: results.json flags {flags}")
    delta = {}
    for m in ("psnr", "ssim", "lpips"):
        vals = results[m]["framewise"] + [results[m]["mean"]]
        check(len(results[m]["framewise"]) == num_preds and bool(np.isfinite(vals).all()),
              f"{phase} results.json: {m} {results[m]}")
        delta[m] = results[m]["mean"] - float_results[m]["mean"]
    decode_ms = decode_stage_ms(exp_path, name, ckpts, batch, num_preds)
    psnr_loss = float(np.abs(np.subtract(results["psnr"]["framewise"],
                                         float_results["psnr"]["framewise"])).max())
    emit({"phase": phase, "batch": batch, "batches": batches, "num_preds": num_preds,
          "modes": modes, "results_flags": flags, "cli_seconds": seconds, "launches": counts,
          "mean": {m: results[m]["mean"] for m in delta},
          "mean_float32": {m: float_results[m]["mean"] for m in delta},
          "mean_delta_int8_minus_float32": delta, "framewise_psnr_int8_loss_db": psnr_loss,
          "decode_stage_ms": decode_ms,
          "decode_speedup": decode_ms["float32"] / decode_ms["int8"]})
    return counts, psnr_loss


# the bf16 int8 path's framewise PSNR may differ from the bf16 path's by at
# most this many times the float32 int8 path's largest framewise loss, plus
# BF16_INT8_PSNR_DB (a bf16 rounding of a frame moves its PSNR by about that)
BF16_INT8_PSNR_LOSSES, BF16_INT8_PSNR_DB = 2, 0.05


def phase_bf16_quant_eval(phase, exp_path, pred_name, ckpts, batch, num_preds, batches,
                          want_launches: dict, f32_loss: float, **modes):
    """The 05 CLI in bf16 (``compute_dtype``) beside int8 ``modes`` on copies
    of ``pred_name``: the main path (its launches: the calibration's bf16
    kernels and the int8 conv, no float32 conv5 or ViT attention),
    ``results.json``'s flags, and its framewise PSNR against the bf16 05
    evaluator's without int8 on the same batches, weights and generator
    seed: within BF16_INT8_PSNR_LOSSES times the float32 int8 path's largest
    framewise loss ``f32_loss`` plus BF16_INT8_PSNR_DB. Returns the launches."""
    from textocvp_tpu_torch.cli import evaluate_predictor
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    bf16 = f"{pred_name}_bf16"  # the eval path's is PRED_NAME_BF16, bf16_cater_eval_step's
    if not (exp_path / "predictors" / bf16).exists():
        quant_experiment(exp_path, pred_name, bf16, ckpts[1], compute_dtype="bfloat16")
    name = quant_experiment(exp_path, pred_name, f"{pred_name}_bf16_int8", ckpts[1],
                            compute_dtype="bfloat16", **modes)
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    rc = evaluate_predictor.main(["-d", str(exp_path), "--name_pred_exp", name,
                                  "--decomp_ckpt", ckpts[0], "--pred_ckpt", ckpts[1],
                                  "--batch_size", str(batch), "--num_seed", "1",
                                  "--num_preds", str(num_preds)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = launches()  # and ends here
    check(rc == 0, f"{phase}: evaluate_predictor returned {rc}")
    want = every_kernel(want_launches)
    check(counts == want, f"{phase}: kernel launches on the main path {counts}, want {want}")
    with open(exp_path / "predictors" / name / "results"
              / f"eval_pred_{ckpts[1]}_NumSeed=1_NumPreds={num_preds}" / "results.json") as f:
        results = json.load(f)
    flags = {k: results.get(k) for k in ("decode_quant", "encode_quant")}
    check(flags == {k: modes.get(k) for k in flags}, f"{phase}: results.json flags {flags}")
    t = time.perf_counter()
    ev = PredictorEvaluator(exp_path, bf16, *ckpts, num_seed=1, num_preds=num_preds,
                            batch_size=batch, results_name="bf16_reference")
    ev.load_data()
    ev.load_models()
    ref = ev.evaluate()
    ref_seconds = time.perf_counter() - t
    del ev
    loss = float(np.abs(np.subtract(results["psnr"]["framewise"],
                                    ref["psnr"]["framewise"])).max())
    limit = BF16_INT8_PSNR_LOSSES * f32_loss + BF16_INT8_PSNR_DB
    check(bool(np.isfinite(results["psnr"]["framewise"]).all()) and loss <= limit,
          f"{phase}: framewise PSNR {loss} dB from the bf16 path's, limit {limit}")
    emit({"phase": phase, "compute_dtype": "bfloat16", "batch": batch, "batches": batches,
          "num_preds": num_preds, "modes": modes, "results_flags": flags,
          "cli_seconds": seconds, "bf16_reference_seconds": ref_seconds, "launches": counts,
          "mean": {m: results[m]["mean"] for m in ("psnr", "ssim", "lpips")},
          "mean_bf16": {m: ref[m]["mean"] for m in ("psnr", "ssim", "lpips")},
          "framewise_psnr_int8_loss_db": loss, "float32_int8_loss_db": f32_loss,
          "limit_db": limit})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- serving artifacts

# The export phases run beside the other phases, in two processes of their
# own: EXPORTER builds each live service, exports it (``serve/export.py``;
# tracing is host work, 27-57 s a service on the host of an NVIDIA H100
# 80GB HBM3 at 700.00 W, PERF.md), records its generator state and starts
# ARTIFACT_WORKER, a fresh ``python -c`` that imports
# textocvp_tpu_torch.serve.export and what that pulls in, nothing else of
# the repository, and loads every artifact (14-47 s each on that host).
# Both then wait for a line on their standard input, so that their requests
# run on an idle card at the end: the live services answer two requests
# each from the recorded state and time steady requests, then the
# artifacts answer the same requests from the same state, time theirs and,
# under torch.profiler behind device spins (longer ones when the profiler
# dropped the trace's first records), count one request's device kernels.
# Each side counts the port's launches a request.
KERNEL_COUNTING = r"""
import json, sys, time
STEADY_REQUESTS = 2  # an artifact's and its live service's steady 8-row requests
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from textocvp_tpu_torch.ops import conv5, conv_int8, slot_attention_kernel, vit_attention

# the export processes run beside the main timeline's 02 / 04 phases (about
# 50 GB): a quarter of the card bounds their transients (a cuDNN plan whose
# workspace does not fit falls back to the next), so both fit
torch.cuda.set_per_process_memory_fraction(0.25)

counters = {"slot_attention": slot_attention_kernel.slot_attention_cuda,
            "vit_attention": vit_attention.vit_attention_cuda, "conv5": conv5.conv5_cuda,
            "conv_int8": conv_int8.conv_int8_cuda,
            "conv5_bf16": conv5.conv5_bf16_cuda,
            "vit_attention_bf16": vit_attention.vit_attention_bf16_cuda}
kernel_names = {"slot_attention": "slot_attention_cluster_kernel",
                "vit_attention": "attention_kernel", "conv5": "conv5_kernel",
                "conv_int8": "conv_int8_kernel", "conv5_bf16": "conv5_bf16_kernel",
                "vit_attention_bf16": "attention_bf16_kernel"}


def answer(svc, requests, replies_path, trace):
    replies, launches = {}, []
    for i, (frames, captions) in enumerate(requests):
        before = {k: f.launches for k, f in counters.items()}
        replies[f"reply_{i}"] = svc.predict(frames, captions)
        launches.append({k: f.launches - before[k] for k, f in counters.items()})
    np.savez(replies_path, **replies)
    frames, captions = requests[0]
    steady = []
    for _ in range(STEADY_REQUESTS):
        t = time.perf_counter()
        svc.predict(frames, captions)
        steady.append(1e3 * (time.perf_counter() - t))
    out = {"launches": launches, "steady_ms": steady}
    for spins in ((8, 64, 512) if trace else ()):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(25_000_000)
            torch.cuda.synchronize()
            svc.predict(frames, captions)
            torch.cuda._sleep(25_000_000)
            torch.cuda.synchronize()
        names = [n for _, n in sorted((e.start_ns(), e.name())
                                      for e in prof.profiler.kineto_results.events()
                                      if e.device_type() == DeviceType.CUDA)]
        body = [i for i, n in enumerate(names) if "spin_kernel" not in n]
        out["trace_whole"] = bool(body) and 0 < body[0] and body[-1] < len(names) - 1
        out["trace_spins"] = spins
        out["traced_kernels"] = {k: sum(name in n for n in names)
                                 for k, name in kernel_names.items()}
        if out["trace_whole"]:
            break
    return out
"""
ARTIFACT_WORKER = KERNEL_COUNTING + r"""
from textocvp_tpu_torch.serve.export import ExportedPredictionService

spec = json.load(open(sys.argv[1]))
services, load_s = {}, {}
for phase, a in spec.items():
    t = time.perf_counter()
    services[phase] = ExportedPredictionService(a["artifact"])
    load_s[phase] = time.perf_counter() - t
torch.cuda.empty_cache()
print("loaded", json.dumps(load_s), flush=True)
sys.stdin.readline()  # the card is free
results = {}
for phase, a in spec.items():
    d = np.load(a["inputs"])
    svc = services.pop(phase)
    svc.generator.set_state(torch.from_numpy(d["state"]))
    requests = [(d[f"frames_{i}"], list(d[f"captions_{i}"])) for i in range(int(d["requests"]))]
    results[phase] = {"load_s": load_s[phase], **answer(svc, requests, a["replies"], True)}
    del svc
    torch.cuda.empty_cache()
json.dump(results, open(sys.argv[2], "w"))
"""
EXPORTER = KERNEL_COUNTING + r"""
import subprocess
from pathlib import Path
from textocvp_tpu_torch.serve import PredictionService, export_service

spec = json.load(open(sys.argv[1]))
services, lines = {}, {}
for phase, a in spec.items():
    svc = PredictionService(a["exp"], a["pred_name"], a["ckpt"], a["ckpt"],
                            batch_size=a["batch"], max_tokens=a["max_tokens"])
    d = dict(np.load(a["inputs"]))
    frames, captions = d["frames_0"], list(d["captions_0"])
    if a["calibrate"]:
        svc.calibrate(frames, captions)
    else:
        svc.warmup()
    t = time.perf_counter()
    export_service(svc, a["artifact"])
    lines[phase] = {"export_s": time.perf_counter() - t,
                    "decode_quant": svc._quant_mode, "encode_quant": svc._encode_quant_mode,
                    "artifact_bytes": {p.name: p.stat().st_size
                                       for p in Path(a["artifact"]).iterdir()}}
    svc.recorded = svc.generator.get_state()
    np.savez(a["inputs"], **d, state=svc.recorded.numpy())
    services[phase] = svc
    torch.cuda.empty_cache()  # hold only the weights while the other phases use the card
log = open(sys.argv[3], "w")
worker = subprocess.Popen([sys.executable, "-c", sys.argv[4], sys.argv[1], sys.argv[5]],
                          stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT, text=True)
print("exported", flush=True)
sys.stdin.readline()  # the card is free
for phase, a in spec.items():
    d = np.load(a["inputs"])
    svc = services.pop(phase)
    svc.generator.set_state(svc.recorded)
    requests = [(d[f"frames_{i}"], list(d[f"captions_{i}"])) for i in range(int(d["requests"]))]
    lines[phase].update(answer(svc, requests, a["live_replies"], False))
    del svc
    torch.cuda.empty_cache()
worker.stdin.write("go\n")
worker.stdin.flush()
lines["_worker_rc"] = worker.wait(timeout=900)
json.dump(lines, open(sys.argv[2], "w"))
"""
EXPORTS = {}  # the export processes, until finish_exports


def run_export(tmp: Path):
    """Start the export phases beside the later ones (EXPORTER): both
    serving paths' services at batch 8, over the experiments ``run_path``
    wrote, a CATER one with ``decode_quant: int8`` calibrated on a
    request's frames, and the CATER one in bf16 without and with int8.
    ``finish_exports`` lets them answer."""
    cater = tmp / PATHS[0].name / "exp"
    int8 = quant_experiment(cater, PRED_NAME, f"{PRED_NAME}_int8", "random", decode_quant="int8")
    bf16 = bf16_experiment(cater)
    bf16_int8 = quant_experiment(cater, bf16, f"{bf16}_int8", "random", decode_quant="int8")
    rng = np.random.default_rng(SEED + 31)
    spec = {}
    for phase, path, exp, pred in (
            *((f"export_{p.name}", p, tmp / p.name / "exp", PRED_NAME) for p in PATHS),
            ("quant_export_cater", PATHS[0], cater, int8),
            ("bf16_export_cater", PATHS[0], cater, bf16),
            ("bf16_quant_export_cater", PATHS[0], cater, bf16_int8)):
        video = rng.uniform(0, 1, (BATCH, 1, path.res, path.res, 3)).astype(np.float32)
        captions = np.array(path.captions[:BATCH])
        inputs = tmp / f"{phase}_inputs.npz"
        # an 8-row float32 request and a 3-row uint8 one
        np.savez(inputs, requests=2, frames_0=video, captions_0=captions,
                 frames_1=np.round(video[:3] * 255).astype(np.uint8), captions_1=captions[:3])
        spec[phase] = {"exp": str(exp), "pred_name": pred, "ckpt": "random", "batch": BATCH,
                       "max_tokens": MAX_TOKENS, "calibrate": "quant" in phase,
                       "path": path.name, "artifact": str(tmp / f"artifact_{phase}"),
                       "inputs": str(inputs), "replies": str(tmp / f"{phase}_replies.npz"),
                       "live_replies": str(tmp / f"{phase}_live.npz")}
    (tmp / "exports.json").write_text(json.dumps(spec))
    log = open(tmp / "exporter.log", "w")
    EXPORTS.update(spec=spec, log=log, tmp=tmp, started=time.perf_counter(),
                   proc=subprocess.Popen(
                       [sys.executable, "-c", EXPORTER, str(tmp / "exports.json"),
                        str(tmp / "exporter_out.json"), str(tmp / "artifacts.log"),
                        ARTIFACT_WORKER, str(tmp / "artifacts_out.json")],
                       stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT, text=True,
                       cwd=ROOT))


def finish_exports():
    """Let the export processes answer on the idle card and check each
    artifact: its replies equal the live service's bit for bit, it launches
    the port's kernels as the live one does, and under the profiler one
    request holds one slot-attention device kernel (and 3 conv5, 3 int8-conv
    or 12 ViT-attention kernels); its steady ms a request beside the live
    one's. One line a phase. Returns each artifact's launches."""
    proc, tmp = EXPORTS["proc"], EXPORTS["tmp"]
    t = time.perf_counter()
    proc.stdin.write("go\n")
    proc.stdin.flush()
    rc = proc.wait(timeout=900)
    EXPORTS["log"].close()
    logs = "".join((tmp / f).read_text()[-2000:] for f in ("exporter.log", "artifacts.log")
                   if (tmp / f).is_file())
    check(rc == 0, f"the exporter failed ({rc}):\n{logs}")
    live = json.loads((tmp / "exporter_out.json").read_text())
    check(live.pop("_worker_rc") == 0, f"the artifacts' process failed:\n{logs}")
    out = json.loads((tmp / "artifacts_out.json").read_text())
    counts = {}
    for phase, a in EXPORTS["spec"].items():
        got, mine = out[phase], live[phase]
        with np.load(a["replies"]) as r, np.load(a["live_replies"]) as want:
            equal = [bool(np.array_equal(r[k], want[k])) for k in sorted(want.files)]
        check(len(equal) == 2 and all(equal),
              f"{phase}: the artifact's replies differ from the live service's: {equal}")
        check(got["launches"] == mine["launches"],
              f"{phase}: launches a request, artifact {got['launches']} live {mine['launches']}")
        kernels, want_k = got["traced_kernels"], mine["launches"][0]
        check(got["trace_whole"] and kernels == want_k and want_k["slot_attention"] == 1,
              f"{phase}: the artifact's traced device kernels of a request {kernels} "
              f"(whole trace: {got['trace_whole']}), live launches {want_k}")
        emit({"phase": phase, "path": a["path"], "batch": BATCH,
              **{k: mine[k] for k in ("decode_quant", "encode_quant", "export_s",
                                      "artifact_bytes")},
              "artifact_load_s": got["load_s"],
              "processes_s": time.perf_counter() - EXPORTS["started"],
              "answer_wait_s": time.perf_counter() - t, "replies_equal_live": equal,
              "launches_per_request": got["launches"], "traced_kernels_per_request": kernels,
              "trace_fence_spins": got["trace_spins"],
              "steady_8_row_ms": {"artifact": got["steady_ms"], "live": mine["steady_ms"]}})
        counts[phase] = {k: sum(c[k] for c in got["launches"]) for k in got["launches"][0]}
    return counts


def run_quant(tmp: Path, eval_exp: Path, clip_exp: Path):
    """int8 on the card: the CATER 05 CLI at B=64 with ``tpu.decode_quant``
    over the eval path's experiment (random weights; against the float CLI's
    ``results.json`` of the eval phase); CLIPort 05 at B=16 with both modes
    over the CLIPort chain's predictor (02 and 04 trained for a few steps;
    against the clip_eval phase's). (The quantized CATER service's artifact
    is ``run_export``'s.) Returns each path's launches."""
    counts = {}
    with open(eval_results_path(eval_exp)) as f:
        float_results = json.load(f)
    batches = EVAL_VIDEOS // EVAL_BATCH
    # the calibration's float decode of the first batch: 3 conv5 launches
    counts["quant_eval"], loss = phase_quant_eval(
        "quant_eval", eval_exp, PRED_NAME, float_results, ("random", "random"), EVAL_BATCH,
        EVAL_PREDS, batches, {"slot_attention": batches, "conv5": 3, "conv_int8": 3 * batches},
        decode_quant="int8")
    # in bf16: the calibration's decode through conv5's bf16 kernel
    counts["bf16_quant_eval"] = phase_bf16_quant_eval(
        "bf16_quant_eval", eval_exp, PRED_NAME, ("random", "random"), EVAL_BATCH, EVAL_PREDS,
        batches, {"slot_attention": batches, "conv5_bf16": 3, "conv_int8": 3 * batches}, loss,
        decode_quant="int8")
    clip_ckpts = ("checkpoint_epoch_final", "checkpoint_epoch_final")
    with open(clip_exp / "predictors" / CLIP_PRED_NAME / "results" / (
            f"eval_pred_checkpoint_epoch_final_NumSeed=1_NumPreds={CLIP_PREDS}")
            / "results.json") as f:
        float_results = json.load(f)
    batches = dict(CLIP_EPISODES)["test"] // CLIP_EVAL_BATCH
    # the calibration's float ViT pass over the first batch's seed frames:
    # 12 more ViT-attention launches; 4 int8 CNN-head convs a batch
    counts["clip_quant_eval"], loss = phase_quant_eval(
        "clip_quant_eval", clip_exp, CLIP_PRED_NAME, float_results, clip_ckpts,
        CLIP_EVAL_BATCH, CLIP_PREDS, batches,
        {"slot_attention": batches, "vit_attention": VIT_BLOCKS * (batches + 1),
         "conv_int8": len(cnn_head_layers()) * batches},
        decode_quant="int8", encode_quant="int8")
    counts["bf16_clip_quant_eval"] = phase_bf16_quant_eval(
        "bf16_clip_quant_eval", clip_exp, CLIP_PRED_NAME, clip_ckpts, CLIP_EVAL_BATCH,
        CLIP_PREDS, batches,
        {"slot_attention": batches, "vit_attention_bf16": VIT_BLOCKS * (batches + 1),
         "conv_int8": len(cnn_head_layers()) * batches}, loss,
        decode_quant="int8", encode_quant="int8")
    return counts


# ------------------------------------------------------------------ the mesh

MESH_LAUNCH_ENV = ("TEXTOCVP_COORDINATOR", "TEXTOCVP_NUM_PROCESSES", "TEXTOCVP_PROCESS_ID")
MESH_TP_BATCH, MESH_TP_PREDS = 8, 3  # the shared-card 04 steps
# the float32 TP step's parameters against world 1's, in lr: Adam's first
# update moves an element by about lr, so a sharded leaf left unchanged
# reads 1 lr and one with its update's sign flipped 2 lr
MESH_TP_PARAM_LRS = 0.5
MESH_WORKER_CMD = "import sys, chip_smoke; chip_smoke.mesh_worker(*sys.argv[1:])"
CLIP_MESH_BATCH = 2  # the shared card's CLIPort requests
CLIP_INT8_NAME = "textocvp_t5_int8"  # the CLIPort serving experiment with int8 on
PRED_NAME_BF16 = f"{PRED_NAME}_bf16"  # a served experiment's predictor in bf16
# The shared card's services: (name, experiment, predictor, mesh axes, batch),
# each float reply held to this share of its largest value from one
# process's. Every one (and its reference) predicts MESH_PREDS frames of its
# experiment, fewer than a request's 19 / 9, so that the shared card's ranks
# keep within the phases beside them: a rollout's first frames do not depend
# on its length, and every path of the mesh still runs.
MESH_PREDS = {"serve_exp": 5, "clip_exp": 3}
MESH_SERVES = (
    ("data1_model2", "serve_exp", PRED_NAME, {"data": 1, "model": 2}, BATCH),
    ("data2", "serve_exp", PRED_NAME, {"data": 2, "model": 1}, BATCH),
    ("seq_parallel_b1", "serve_exp", PRED_NAME, {"data": 2, "model": 1}, 1),
    ("clip_data1_model2", "clip_exp", PRED_NAME, {"data": 1, "model": 2}, CLIP_MESH_BATCH),
    ("clip_seq_parallel_b1", "clip_exp", PRED_NAME, {"data": 2, "model": 1}, 1),
    ("clip_int8_data2", "clip_exp", CLIP_INT8_NAME, {"data": 2, "model": 1}, CLIP_MESH_BATCH),
    ("bf16_data2", "serve_exp", PRED_NAME_BF16, {"data": 2, "model": 1}, BATCH),
    ("bf16_data1_model2", "serve_exp", PRED_NAME_BF16, {"data": 1, "model": 2}, BATCH),
    ("bf16_clip_data1_model2", "clip_exp", PRED_NAME_BF16, {"data": 1, "model": 2},
     CLIP_MESH_BATCH),
)
# model=2: sums in other orders (1e-4, as the predictors' parallelism is held);
# data=2: a row's sums at another batch (1e-5 on CATER, in bf16 too: ROADMAP.md
# section 3's row limit)
MESH_REPLY_TOLERANCE = {"data1_model2": 1e-4, "data2": 1e-5, "seq_parallel_b1": 1e-5,
                        "clip_data1_model2": 1e-4, "clip_seq_parallel_b1": 1e-4,
                        "bf16_data2": 1e-5}
# the bf16 services, each held to the one-process bf16 reply by
# tests/torch_bf16.py's rule, the one-process float32 reply its float32 reference
MESH_BF16_SERVES = ("bf16_data2", "bf16_data1_model2", "bf16_clip_data1_model2")
MESH_DECOMP_SHARDED = ("clip_data1_model2", "bf16_clip_data1_model2")
# int8 at data=2: the encode's scales, calibrated on the frames, bit for bit.
# The card sums a row's slot attention and rollout differently at 1 row a
# rank than at 2 (slots 1.2e-6 apart on an H100: chip_int8_rows_probe.py), so the
# decode's scales, calibrated on the predicted slots, are held to this
# relative error, and the reply, whose int8 decode puts every activation
# within that of a .5 boundary a quantum apart, to int8's own error: no
# value further from one process's int8 reply than that reply is from the
# float one.
MESH_INT8_DECODE_SCALES_RTOL = 1e-5


class FirstItems:
    """The first ``n`` items of a dataset, its tokenizer kept (one loader batch)."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n
        self.tokenizer = getattr(dataset, "tokenizer", None)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


@contextmanager
def _timed(out: dict, key: str):
    """Add the seconds of the block to ``out["seconds"][key]`` (where a mesh
    process's time goes)."""
    t = time.perf_counter()
    try:
        yield
    finally:
        out.setdefault("seconds", {})[key] = time.perf_counter() - t


def _synced_ms(fn):
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, 1e3 * (time.perf_counter() - t)


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _mesh_02(spec, videos, steps=2):
    """``steps`` 02 steps of the spec's SAVi experiment from the trainer's
    seeded init and the stream's noise: (parameters, losses, step ms)."""
    from textocvp_tpu_torch.train.trainer import DecompTrainer

    tr = DecompTrainer(spec["decomp_exp"], device=spec["device"])
    tr.setup_model()
    losses, ms = [], []
    for _ in range(steps):
        values, t = _synced_ms(lambda: tr.train_step(videos))
        losses.append(float(values["_total"]))
        ms.append(t)
    return {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}, losses, ms


def _mesh_04_trainer(exp, device):
    from textocvp_tpu_torch.train.predictor_trainer import PredictorTrainer

    tr = PredictorTrainer(exp, "checkpoint_epoch_final", device=device)
    tr.setup_model()
    random_predictor_(tr)
    return tr


def _mesh_04(exp, videos, text, device, steps=2):
    tr = _mesh_04_trainer(exp, device)
    losses, ms = [], []
    for _ in range(steps):
        values, t = _synced_ms(lambda: tr.train_step(videos, **text))
        losses.append(float(values["_total"]))
        ms.append(t)
    return [p.detach().cpu().clone() for p in tr.optimizer.params], losses, ms


def _mesh_05(spec, name):
    """The 05 evaluator over the first CATER test batch of the eval path's
    experiment -> its results.json text."""
    from textocvp_tpu_torch.data.loader import EpochLoader
    from textocvp_tpu_torch.parallel.distributed import loader_process_kwargs
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    ev = PredictorEvaluator(spec["eval_exp"], PRED_NAME, "random", "random", num_seed=1,
                            num_preds=EVAL_PREDS, batch_size=EVAL_BATCH, results_name=name,
                            device=spec["device"])
    ev.load_data()
    ev.test_loader = EpochLoader(FirstItems(ev.test_set, EVAL_BATCH), EVAL_BATCH,
                                 **loader_process_kwargs(ev.mesh))
    ev.load_models()
    ev.evaluate()
    return (ev.exp.results_dir(name) / "results.json").read_text()


def _float_frames_(svc):
    """Have ``svc``'s decode stage return its clipped frames (a bf16 stage's
    cast to float32) times 255, unrounded, in place of the uint8 reply, so
    that ``predict`` (which divides by 255) hands back the frames before the
    reply's rounding: a 1e-7 difference at a rounding edge is a whole 1/255
    of the uint8 reply. An int8 stage decodes with its calibrated scales.
    Returns ``svc``."""
    stage = svc.decode_module

    def forward(pred_slots):
        b, p, s, d = pred_slots.shape
        kw = {} if stage.quant_scales is None else {"quant_scales": stage.quant_scales}
        imgs = stage.model.decode(pred_slots.reshape(b * p, s, d), **kw)["recons_imgs"]
        return (imgs.float().clamp(0.0, 1.0) * 255.0).reshape(b, p, *imgs.shape[1:])

    stage.forward = forward
    return svc


def _mesh_service(spec, batch, mesh_axes=None, float_reply=False, exp="serve_exp",
                  pred=PRED_NAME, num_preds=None):
    from textocvp_tpu_torch.serve import PredictionService

    svc = PredictionService(spec[exp], pred, "random", "random", batch_size=batch,
                            max_tokens=MAX_TOKENS, device=spec["device"], mesh_axes=mesh_axes,
                            num_preds=num_preds)
    return _float_frames_(svc) if float_reply else svc


def _mesh_request(rows, exp="serve_exp"):
    """A request of ``rows`` random frames to the CATER (``serve_exp``) or
    the CLIPort (``clip_exp``) serving experiment."""
    path = PATHS[0] if exp == "serve_exp" else PATHS[1]
    rng = np.random.default_rng(SEED + 41)
    frames = rng.uniform(0, 1, (rows, 1, path.res, path.res, 3)).astype(np.float32)
    return frames, list(path.captions[:rows])


def _int8_scales(svc) -> dict:
    return {"encode": svc.predict_module.encode_scales.cpu().numpy(),
            "decode": svc.decode_module.quant_scales.cpu().numpy()}


def _mesh_inputs(spec, frames, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((batch, frames, CONV5_RES, CONV5_RES, 3), generator=gen).to(spec["device"])


def _mesh_nccl_half(spec, out, tag):
    """The 02 and 04 steps, the 05 batch and an 8-row request; with the
    process group joined, the same through the mesh."""
    from textocvp_tpu_torch.core.experiment import Experiment

    with _timed(out, f"02_{tag}"):
        videos02 = _mesh_inputs(spec, TRAIN_FRAMES, TRAIN_BATCH, SEED + 42)
        out[f"params_02_{tag}"], out[f"losses_02_{tag}"], out[f"ms_02_{tag}"] = _mesh_02(
            spec, videos02)
        del videos02
    with _timed(out, f"04_{tag}"):
        videos04 = _mesh_inputs(spec, PRED_FRAMES, TRAIN_BATCH, SEED + 43)
        text = {k: v.to(spec["device"]) for k, v in caption_batch(
            Experiment(spec["pred_exp"]).params, TRAIN_BATCH).items()}
        out[f"params_04_{tag}"], out[f"losses_04_{tag}"], out[f"ms_04_{tag}"] = _mesh_04(
            spec["pred_exp"], videos04, text, spec["device"])
        del videos04
        gc.collect()
        torch.cuda.empty_cache()
    with _timed(out, f"05_{tag}"):
        out[f"results_05_{tag}"] = _mesh_05(spec, f"mesh_nccl_{tag}")
    with _timed(out, f"serve_{tag}"):
        svc = _mesh_service(spec, BATCH, {"data": -1, "model": 1} if tag == "mesh" else None)
        out[f"reply_{tag}"] = svc.predict(*_mesh_request(BATCH))
        svc.close()


def _mesh_shared_card(spec, rank, launch, out):
    """The single-process references first, before the group: rank 0 the
    float replies of the CATER 8-row and 1-row requests and of the CLIPort
    2-row and 1-row ones, and the CATER 8-row and CLIPort 2-row ones in
    bf16, rank 1 the 04 step at world size 1 in float32 and in bf16 and the
    int8 CLIPort service's reply and scales (handed to rank 0 in a file);
    then both ranks join the gloo group of two and run the mesh services of
    ``MESH_SERVES`` (rank 0 compares the replies) and the tensor-parallel 04
    step in float32 and in bf16 (rank 1 compares them), then the emergency
    checkpoint of the float32 step's trainer (:func:`_tp_emergency`).
    ``out["launches"]`` counts the mesh's own launches, from the join on."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.parallel import distributed as pdist
    from textocvp_tpu_torch.parallel.partitioning import gather_state_dict

    with _timed(out, "inputs"):
        videos = _mesh_inputs(spec, PRED_CONTEXT + MESH_TP_PREDS, MESH_TP_BATCH, SEED + 44)
        text = {k: v.to(spec["device"]) for k, v in caption_batch(
            Experiment(spec["tp_exp"]).params, MESH_TP_BATCH).items()}

    def step(exp, initial=False):
        """One 04 step of ``exp``'s trainer: (losses, the gradients' global
        norm, the updated trained leaves gathered, the replicated leaves'
        digest, the sharded names, lr, the step's ms (backward and update,
        its first), the trained leaves before the step with ``initial``
        (world size 1 only), the trainer)."""
        tr = _mesh_04_trainer(exp, spec["device"])
        trained = {n for n, p in tr.model.named_parameters() if p.requires_grad}
        before = ({k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()
                   if k in trained} if initial else None)
        values, ms = _synced_ms(lambda: tr.backward(videos, tr._noise(MESH_TP_BATCH), **text))
        stats, opt_ms = _synced_ms(tr.optimizer.step)
        norm = float(stats["grad_norm"])
        full = (gather_state_dict(tr.model, tr.mesh.model_group) if tr.mesh.tensor_parallel
                else tr.model.state_dict())
        sharded = {n for n, p in tr.model.named_parameters() if getattr(p, "tp_shard", None)}
        replicated = [p for n, p in tr.model.named_parameters() if n not in sharded]
        return ({k: float(v) for k, v in values.items()}, norm,
                {k: v.detach().cpu().clone() for k, v in full.items() if k in trained},
                _digest(replicated), sorted(sharded), tr.lr_schedule(0), ms + opt_ms, before, tr)

    refs, int8_ref = {}, Path(spec["tmp"]) / "mesh_clip_int8_reference.npz"
    with _timed(out, "references"):
        if rank == 0:
            for exp, pred, b in (("serve_exp", PRED_NAME, BATCH), ("serve_exp", PRED_NAME, 1),
                                 ("serve_exp", PRED_NAME_BF16, BATCH),
                                 ("clip_exp", PRED_NAME, CLIP_MESH_BATCH),
                                 ("clip_exp", PRED_NAME, 1),
                                 ("clip_exp", PRED_NAME_BF16, CLIP_MESH_BATCH)):
                svc = _mesh_service(spec, b, float_reply=True, exp=exp, pred=pred,
                                    num_preds=MESH_PREDS[exp])
                refs[exp, pred, b] = svc.predict(*_mesh_request(b, exp))
                del svc
        else:
            refs["step"] = step(spec["w1_exp"])[:-1]  # not its trainer
            refs["step_bf16"] = step(spec["w1_bf16_exp"], initial=True)[:-1]
            svc = _mesh_service(spec, CLIP_MESH_BATCH, float_reply=True, exp="clip_exp",
                                pred=CLIP_INT8_NAME, num_preds=MESH_PREDS["clip_exp"])
            reply = svc.predict(*_mesh_request(CLIP_MESH_BATCH, "clip_exp"))
            np.savez(int8_ref, reply=reply, **_int8_scales(svc))
            del svc
        torch.cuda.empty_cache()
    with _timed(out, "join"):
        os.environ.update(launch)
        check(pdist.maybe_initialize_distributed(), "no process group")
    out["backend"] = pdist._STATE["backend"]
    reset_launches()  # the mesh's launches from here on, the references' not
    if rank == 0:  # written by rank 1 before it joined
        with np.load(int8_ref) as f:
            refs["clip_exp", CLIP_INT8_NAME, CLIP_MESH_BATCH] = f["reply"]
            int8_scales = {k: f[k] for k in ("encode", "decode")}
    for name, exp, pred, axes, b in MESH_SERVES:
        if torch.cuda.is_available():  # each service's own peak, and the process's
            out["peak_gb"] = max(out.get("peak_gb", 0), torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
        with _timed(out, name):
            svc = _mesh_service(spec, b, axes, float_reply=True, exp=exp, pred=pred,
                                num_preds=MESH_PREDS[exp])
            if rank == 0:
                got, ms = _synced_ms(lambda: svc.predict(*_mesh_request(b, exp)))
                svc.close()
                ref = refs[exp, pred, b]
                out[name] = {"max_abs_err": float(np.abs(got - ref).max()),
                             "max_abs_ref": float(np.abs(ref).max()),
                             "seq_parallel": svc._seq_parallel,
                             "decomp_sharded": svc._decomp_sharded, "shape": list(got.shape),
                             "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                                         if torch.cuda.is_available() else 0),
                             "request_ms": ms}
                if name in MESH_BF16_SERVES:
                    f32 = refs[exp, PRED_NAME, b]
                    out[name]["bf16"] = {
                        "vs_one_process_bf16": e_max(got, ref, f32),
                        "vs_one_process_f32": e_max(got, f32, f32),
                        "one_process_bf16_vs_f32": e_max(ref, f32, f32)}
                if pred == CLIP_INT8_NAME:
                    out[name]["scales_rel_err"] = {
                        k: float(np.abs(v - int8_scales[k]).max() / np.abs(int8_scales[k]).max())
                        for k, v in _int8_scales(svc).items()}
                    out[name]["int8_error_of_one_process"] = float(
                        np.abs(ref - refs["clip_exp", PRED_NAME, b]).max())
            else:
                svc.follow()
            del svc
            torch.cuda.empty_cache()
    with _timed(out, "tp_step_bf16"):
        tp_bf16 = step(spec["tp_bf16_exp"])[:-2]  # not its trainer
    with _timed(out, "tp_step"):
        *tp, _, tr = step(spec["tp_exp"])
    out["launches"] = launches()
    out["tp_step"] = {"replicated_digest": tp[3], "sharded": len(tp[4])}
    out["tp_step_bf16"] = {"replicated_digest": tp_bf16[3], "sharded": len(tp_bf16[4])}
    with _timed(out, "tp_emergency"):
        out["tp_emergency"] = _tp_emergency(tr, rank)
    del tr
    if rank == 1:
        with _timed(out, "compare"):
            (losses, norm, params, *_, lr, ms), w1 = tp, refs["step"]
            (w_losses, w_norm, w_params, *_), w_ms = w1, w1[6]
            out["tp_step"].update(
                losses=losses, world1_losses=w_losses, grad_norm=norm,
                world1_grad_norm=w_norm, lr=lr,
                max_param_diff=max(float((params[k] - v).abs().max())
                                   for k, v in w_params.items()),
                params_compared=len(w_params),
                loss_rel_err=max(abs(losses[k] - w_losses[k]) / abs(w_losses[k])
                                 for k in w_losses),
                grad_norm_rel_err=abs(norm - w_norm) / w_norm, step_ms=ms, world1_step_ms=w_ms)
            out["tp_step_bf16"].update(
                bf16_step_errors(tp_bf16, refs["step_bf16"], refs["step"]),
                step_ms=tp_bf16[6], world1_step_ms=refs["step_bf16"][6])


# The bf16 TP step's parameters against world 1's bf16 step, leaf by leaf:
# Adam's first update moves an element by about lr in its gradient's sign, so
# two steps differ by about 2 lr where their gradients' signs differ, which
# bf16 roundings do where a gradient is near 0. An element is "off" when it
# is more than BF16_TP_OFF_LRS lr from the other step's. A leaf's count off
# from world 1's bf16 step may be at most BF16_TP_OFF_TIMES its count of
# world 1's bf16 step off from float32's, plus a 2**-8 share of the leaf
# (BF16_TP_OFF_FLOOR elements at least). A sharded leaf left unchanged or
# with its sign flipped is off everywhere: the check plants both in the
# largest sharded leaf and must reject them.
BF16_TP_OFF_LRS, BF16_TP_OFF_TIMES, BF16_TP_OFF_FLOOR = 0.5, 2, 4


def _off_counts(a: dict, b: dict, lr: float) -> dict:
    return {k: int(((a[k] - v).abs() > BF16_TP_OFF_LRS * lr).sum()) for k, v in b.items()}


def _worst_off(off: dict, ref_off: dict, sizes: dict) -> dict:
    """The leaf whose count ``off`` most exceeds its limit, with its reading."""
    def excess(k):
        return off[k] - (BF16_TP_OFF_TIMES * ref_off[k]
                         + max(BF16_TP_OFF_FLOOR, math.ceil(sizes[k] / 256)))

    k = max(off, key=excess)
    return {"leaf": k, "off": off[k], "world1_bf16_vs_f32_off": ref_off[k], "numel": sizes[k],
            "excess": excess(k)}


def bf16_step_errors(tp, w1, w1_f32) -> dict:
    """The bf16 tensor-parallel 04 step ``tp`` against world 1's bf16 step
    ``w1`` (with its leaves before the update) and its float32 one
    ``w1_f32`` (each ``step()``'s losses, the gradients' global norm and the
    updated leaves), for tests/torch_bf16.py's rule: each distance of ``tp``
    from ``w1`` against ``w1``'s from ``w1_f32``, the losses and the norm over
    the float32 ones; the leaves by their counts off (``_worst_off``), and
    the same reading with the largest sharded leaf of ``tp`` planted unchanged
    and flipped."""
    (losses, norm, params, _, sharded, lr, *_), (w_losses, w_norm, w_params, *_) = tp, w1
    f_losses, f_norm, f_params = w1_f32[:3]
    before = w1[7]

    def rel(a, b, f):
        return abs(a - b) / abs(f)

    sizes = {k: v.numel() for k, v in w_params.items()}
    ref_off = _off_counts(w_params, f_params, lr)
    largest = max((k for k in sharded if k in w_params), key=lambda k: sizes[k])
    planted = {"unchanged": {**params, largest: before[largest]},
               "flipped": {**params, largest: 2 * before[largest] - params[largest]}}
    return {"loss": max(rel(losses[k], w_losses[k], f_losses[k]) for k in f_losses),
            "loss_bf16_vs_f32": max(rel(w_losses[k], f_losses[k], f_losses[k])
                                    for k in f_losses),
            "grad_norm": rel(norm, w_norm, f_norm), "grad_norm_bf16_vs_f32": rel(w_norm, f_norm,
                                                                                 f_norm),
            "params_lr": max(float((params[k] - v).abs().max()) for k, v in w_params.items()) / lr,
            "params_lr_bf16_vs_f32": max(float((w_params[k] - v).abs().max())
                                         for k, v in f_params.items()) / lr,
            "leaves": _worst_off(_off_counts(params, w_params, lr), ref_off, sizes),
            "planted": {name: _worst_off(_off_counts(p, w_params, lr), ref_off, sizes)
                        for name, p in planted.items()},
            "off_total": sum(_off_counts(params, w_params, lr).values()),
            "world1_bf16_vs_f32_off_total": sum(ref_off.values()),
            "losses": losses, "world1_losses": w_losses, "grad_norm_value": norm}


def _tp_emergency(tr, rank) -> dict:
    """After the tensor-parallel step, both ranks raise on purpose inside
    ``tr``'s training loop, as its first epoch starts: each writes its own
    file of the emergency checkpoint with no collective
    (``train/checkpoints.py::save_shard``). Rank 0 then joins the set
    (``load_checkpoint``) and holds it bit for bit to the state the
    collective gather gave just before the fault."""
    from textocvp_tpu_torch.parallel.mesh import barrier
    from textocvp_tpu_torch.train.checkpoints import load_checkpoint, shard_files

    from types import SimpleNamespace

    gathered = tr._state(tr.start_epoch)  # the collective gather, before the fault

    def fault(epoch):
        raise RuntimeError("fault on purpose")

    # the step's trainer loads no data: loaders that only take their epoch;
    # and no TensorBoard (its import takes seconds of the shared card's ranks)
    tr.train_loader, tr.valid_loader = SimpleNamespace(), SimpleNamespace()
    tr._setup_writer = lambda: None
    tr.valid_epoch = fault
    try:
        tr.training_loop()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    check(raised == "fault on purpose", f"mesh_shared_card: the trainer's loop raised {raised}")
    barrier()  # every rank's file is written
    name = tr.exp.checkpoint_path(f"emergency_checkpoint_epoch_{tr.start_epoch}")
    files = sorted(shard_files(name))
    check(files == [0, 1] and not name.exists(),
          f"mesh_shared_card: emergency files of ranks {files}, a gathered file "
          f"{name.exists()}")
    result = {"files": sorted(f.name for f in shard_files(name).values())}
    if rank == 0:
        joined = load_checkpoint(name)
        cpu = {k: v.detach().cpu() for k, v in gathered["params"].items()}
        same = (set(joined["params"]) == set(cpu)
                and all(torch.equal(joined["params"][k], v) for k, v in cpu.items())
                and joined["opt_state"]["count"] == gathered["opt_state"]["count"]
                and all(torch.equal(a, b) for key in ("mu", "nu") for a, b in zip(
                    joined["opt_state"][key], gathered["opt_state"][key], strict=True))
                and (joined["epoch"], joined["step"]) == (gathered["epoch"], gathered["step"]))
        check(same, "mesh_shared_card: the joined emergency files are not the gathered state")
        result.update(joined_equals_gathered=same, params=len(cpu),
                      sharded=sum(1 for p in tr.model.parameters()
                                  if getattr(p, "tp_shard", None)),
                      updates=joined["opt_state"]["count"])
    return result


MESH_GO_LIMIT_S = 3000  # the longest a started mesh process waits for its go


def wait_for_go(go: Path):
    """Import what the mesh phases use, then wait until ``go`` exists; exit
    if the process that started this one has gone or after MESH_GO_LIMIT_S."""
    import textocvp_tpu_torch.parallel.distributed  # noqa: F401
    import textocvp_tpu_torch.serve  # noqa: F401
    import textocvp_tpu_torch.train.evaluator  # noqa: F401
    import textocvp_tpu_torch.train.predictor_trainer  # noqa: F401
    import textocvp_tpu_torch.train.trainer  # noqa: F401

    parent, t = os.getppid(), time.perf_counter()
    while not go.exists():
        if os.getppid() != parent or time.perf_counter() - t > MESH_GO_LIMIT_S:
            sys.exit(3)
        time.sleep(0.05)


def mesh_worker(spec_path, out_path, go):
    """The mesh phases' processes (``run_mesh``): ``mesh_nccl`` alone, or one
    rank of ``mesh_shared_card``. Each is started early (:func:`spawn_mesh`),
    imports, and waits for its ``go`` file (:func:`wait_for_go`) before it
    reads its spec. The launch environment is set aside until the plain half
    (or rank 0's references) is done. Deterministic cuDNN and cuBLAS, so
    that a step can be held to another bit for bit."""
    import warnings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    wait_for_go(Path(go))
    spec = json.loads(Path(spec_path).read_text())
    if spec["phase"] == "mesh_shared_card":
        torch.set_num_threads(2)  # beside the main timeline's phases
        # and beside its memory: a quarter of the card each bounds the
        # transients (a cuDNN plan whose workspace does not fit falls back to
        # the next), as the export processes' do
        if torch.cuda.is_available():
            torch.cuda.set_per_process_memory_fraction(0.25)
    launch = {k: os.environ.pop(k) for k in MESH_LAUNCH_ENV if k in os.environ}
    rank = int(launch.get("TEXTOCVP_PROCESS_ID", "0"))
    out = {"rank": rank}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if spec["phase"] == "mesh_nccl":
            from textocvp_tpu_torch.parallel import distributed as pdist

            _mesh_nccl_half(spec, out, "plain")
            with _timed(out, "join"):
                os.environ.update(launch)
                check(pdist.maybe_initialize_distributed(), "no process group")
            out["backend"] = pdist._STATE["backend"]
            reset_launches()
            _mesh_nccl_half(spec, out, "mesh")
            out["launches"] = launches()
        else:
            _mesh_shared_card(spec, rank, launch, out)
    out["nondeterministic"] = sorted({str(w.message)[:160] for w in caught
                                      if "does not have a deterministic" in str(w.message)})
    out["peak_gb"] = max(out.get("peak_gb", 0), torch.cuda.max_memory_allocated() / 1e9
                         if torch.cuda.is_available() else 0)
    if spec["phase"] == "mesh_nccl":
        for k in ("02", "04"):
            a, b = out.pop(f"params_{k}_plain"), out.pop(f"params_{k}_mesh")
            pairs = zip(a.values(), b.values()) if isinstance(a, dict) else zip(a, b)
            out[f"params_equal_{k}"] = all(torch.equal(x, y) for x, y in pairs)
        out["results_equal_05"] = out.pop("results_05_plain") == out.pop("results_05_mesh")
        ra, rb = out.pop("reply_plain"), out.pop("reply_mesh")
        out["reply_equal"] = bool(np.array_equal(ra, rb))
        out["reply_shape"] = list(rb.shape)
    from textocvp_tpu_torch.parallel import distributed as pdist

    pdist.destroy()
    Path(out_path).write_text(json.dumps(out))


def _spawn_mesh(tmp: Path, phase: str, world: int):
    """Start ``world`` processes of ``mesh_worker`` for ``phase``, joined by the
    ``TEXTOCVP_*`` environment; each waits for the go of :func:`_go_mesh`
    (:func:`_finish_mesh` waits for them)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "TEXTOCVP_COORDINATOR": f"127.0.0.1:{port}",
           "TEXTOCVP_NUM_PROCESSES": str(world), "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    spec_path, go = tmp / f"{phase}.json", tmp / f"{phase}.go"
    procs, logs = [], []
    for r in range(world):
        logs.append(open(tmp / f"{phase}_rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_WORKER_CMD, str(spec_path),
             str(tmp / f"{phase}_rank{r}.json"), str(go)],
            env={**env, "TEXTOCVP_PROCESS_ID": str(r)}, cwd=ROOT, stdout=logs[-1],
            stderr=subprocess.STDOUT))
    return {"tmp": tmp, "phase": phase, "world": world, "procs": procs, "logs": logs,
            "spec_path": spec_path, "go": go, "started": time.perf_counter()}


def _go_mesh(run: dict, spec: dict):
    """Write ``run``'s spec and let its processes go."""
    run["spec_path"].write_text(json.dumps({**spec, "phase": run["phase"]}))
    run["spec"] = spec
    run["go"].touch()
    run["started"] = time.perf_counter()


def _finish_mesh(run: dict, timeout: float):
    """Wait for ``run``'s processes (killed past ``timeout``) and return each
    rank's output."""
    tmp, phase, world, procs, logs = (run[k] for k in ("tmp", "phase", "world", "procs",
                                                        "logs"))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = "\n".join(f"--- rank {r}\n" + (tmp / f"{phase}_rank{r}.log").read_text()[-3000:]
                      for r in range(world))
    check(rcs == [0] * world, f"{phase}: the ranks exited with {rcs}:\n{tails}")
    return [json.loads((tmp / f"{phase}_rank{r}.json").read_text()) for r in range(world)]


def spawn_mesh(tmp: Path):
    """Start the mesh phases' processes, ``mesh_shared_card``'s two ranks and
    ``mesh_nccl``'s one, which import (host work on a core each, beside the
    phases before :func:`start_mesh`) and wait for their go. Returns them."""
    return {"shared": _spawn_mesh(tmp, "mesh_shared_card", 2),
            "nccl": _spawn_mesh(tmp, "mesh_nccl", 1)}


def start_mesh(mesh: dict, tmp: Path, train_exp: Path, device="cuda"):
    """Write the mesh phases' experiments (over the SAVi of ``train_exp``, the
    CATER serving path's and the eval path's) and let ``mesh_shared_card``'s
    two ranks of ``mesh`` (:func:`spawn_mesh`) go (about 60 s, mostly the
    host's: gloo's copies and the rollout's dispatch). They run beside
    phases that time nothing, and :func:`wait_mesh` waits for them before
    the next timed one; ``mesh_nccl``'s process waits for :func:`run_mesh`'s
    go. Returns the running phase, ``mesh_nccl``'s process under
    ``"nccl"``."""
    from textocvp_tpu_torch.core.experiment import Experiment

    spec = {"decomp_exp": str(train_experiment(tmp / "mesh_train", tmp / "CATER_train",
                                               lr_warmup=False)),
            "eval_exp": str(tmp / "eval" / "exp"), "serve_exp": str(tmp / PATHS[0].name / "exp"),
            "clip_exp": str(clip_int8_experiment(tmp / PATHS[1].name / "exp")),
            "pred_exp": str(pred_experiment(train_exp, "mesh_b64", lr_warmup=False)),
            "device": device, "tmp": str(tmp)}
    for exp in (spec["decomp_exp"], spec["pred_exp"]):  # the 02 / 04 CLIs' mesh, literally
        params = Experiment(exp).params
        params["tpu"] = {**(params.get("tpu") or {}), "mesh_axes": {"data": -1, "model": 1}}
        Experiment(exp).save_params(params)
    # the tensor-parallel 04 steps and world size 1's, in float32 and in bf16
    for name, axes, dtype in (("w1_exp", None, "float32"), ("w1_bf16_exp", None, "bfloat16"),
                              ("tp_exp", {"data": 1, "model": 2}, "float32"),
                              ("tp_bf16_exp", {"data": 1, "model": 2}, "bfloat16")):
        exp = pred_experiment(train_exp, f"mesh_{name}", num_preds=MESH_TP_PREDS,
                              batch_size=MESH_TP_BATCH, lr_warmup=False)
        params = Experiment(exp).params
        params["tpu"] = {**(params.get("tpu") or {}), "compute_dtype": dtype,
                         **({"mesh_axes": axes} if axes else {})}
        Experiment(exp).save_params(params)
        spec[name] = str(exp)
    shared = mesh["shared"]
    _go_mesh(shared, spec)
    shared["nccl"] = mesh["nccl"]
    return shared


def clip_int8_experiment(parent: Path) -> Path:
    """The CLIPort serving experiment's predictor again as ``CLIP_INT8_NAME``,
    with ``tpu.decode_quant`` and ``tpu.encode_quant`` int8 (its checkpoint
    hard-linked). Returns ``parent``."""
    from textocvp_tpu_torch.core.experiment import Experiment

    src = Experiment(parent / "predictors" / PRED_NAME)
    dst = Experiment(parent / "predictors" / CLIP_INT8_NAME)
    params = src.params
    params["tpu"] = {**(params.get("tpu") or {}), "decode_quant": "int8", "encode_quant": "int8"}
    dst.save_params(params)
    dst.models_dir.mkdir(parents=True, exist_ok=True)
    os.link(src.checkpoint_path("random"), dst.checkpoint_path("random"))
    return parent


def wait_mesh(shared: dict):
    """Wait for ``mesh_shared_card``'s ranks (let go by :func:`start_mesh`):
    their outputs go into ``shared["ranks"]``, and the seconds the main
    timeline waited for them into ``shared["wait_s"]``."""
    t = time.perf_counter()
    shared["ranks"] = _finish_mesh(shared, timeout=600)
    shared["wait_s"] = time.perf_counter() - t
    shared["processes_s"] = time.perf_counter() - shared["started"]


def run_mesh(shared: dict, device="cuda"):
    """The mesh (``parallel/``) on the card, in processes of its own.

    ``mesh_nccl``, last, the card otherwise idle: one process, a process
    group of one rank over NCCL (``TEXTOCVP_*`` environment,
    ``tpu.mesh_axes`` ``{"data": -1, "model": 1}``): two CATER 02 steps and
    two 04 steps at B=64, the CATER 05 batch and an 8-row served request,
    first without the group, then through the mesh; parameters,
    results.json and reply bit for bit equal, and the steps' ms side by side
    (the collectives' cost at world size 1).

    ``mesh_shared_card`` (run by :func:`start_mesh` and :func:`wait_mesh`,
    checked here): two ranks on the one H100 over gloo, each service at
    ``MESH_PREDS`` predicted frames: the CATER service at batch 8 with
    ``data=1, model=2`` (float reply within 1e-4 of its largest value of the
    single-process one), ``data=2`` (1e-5) and at batch 1 under
    sequence-parallel decode (1e-5); the full-width CLIPort service
    (ExtendedDINOSAUR sharded, ``shard_decomp_``) at batch 2 with ``data=1,
    model=2`` (1e-4), at batch 1 under sequence-parallel decode (1e-4), and
    with int8 (``decode_quant`` and ``encode_quant``) at ``data=2`` (the
    encode's scales one process's bit for bit, the decode's within
    MESH_INT8_DECODE_SCALES_RTOL, the reply within int8's own error); in
    bf16 (``MESH_BF16_SERVES``) the CATER service at ``data=2`` and
    ``data=1, model=2`` and the CLIPort one at ``data=1, model=2``, each
    within 2 e(one process bf16, one process float32) + 2**-8 of one
    process's bf16 reply (``data=2`` also within 1e-5), each request timed;
    a CATER 04 step at B=8,
    p=3 on ``model=2`` against world size 1 (losses 1e-5, the gradients'
    global norm 1e-4, no parameter more than MESH_TP_PARAM_LRS lr from world
    1's after the update) and in bf16 against world size 1's bf16 and
    float32 steps (:func:`bf16_step_errors`), the replicated leaves
    bit-equal across the ranks, then the emergency checkpoint under tensor
    parallelism (both ranks raise; each writes its own file with no
    collective; their join is the gathered state bit for bit:
    :func:`_tp_emergency`). The mesh's own launches include slot attention,
    conv5 in float32 and bf16, the ViT attention in float32 and bf16 and the
    int8
    conv. Returns each phase's launches."""
    return _mesh_phases(shared, device)


def _mesh_phases(shared, device):
    counts = {}
    gc.collect()
    torch.cuda.empty_cache()
    _go_mesh(shared["nccl"], shared["spec"])  # its process was started by spawn_mesh
    (one,) = _finish_mesh(shared["nccl"], timeout=600)
    check(one["backend"] == ("nccl" if device == "cuda" else "gloo"),
          f"mesh_nccl: backend {one['backend']}")
    equal = {k: one[k] for k in ("params_equal_02", "params_equal_04", "results_equal_05",
                                 "reply_equal")}
    check(all(equal.values()), f"mesh_nccl: world size 1 through the mesh is not bit for bit "
                               f"the plain run: {equal}; nondeterministic ops: "
                               f"{one['nondeterministic']}")
    for k in ("02", "04"):
        check(one[f"losses_{k}_plain"] == one[f"losses_{k}_mesh"], f"mesh_nccl: {k} losses")
    counts["mesh_nccl"] = every_kernel(one["launches"])
    check(device != "cuda" or (counts["mesh_nccl"]["slot_attention"] > 0
                               and counts["mesh_nccl"]["conv5"] > 0),
          f"mesh_nccl: launches {counts['mesh_nccl']}")
    emit({"phase": "mesh_nccl", "backend": one["backend"], "world": 1,
          "mesh_axes": {"data": -1, "model": 1}, **equal,
          "step_ms": {f"{k}_b{TRAIN_BATCH}": {"plain": one[f"ms_{k}_plain"],
                                              "mesh": one[f"ms_{k}_mesh"]} for k in ("02", "04")},
          "losses": {k: one[f"losses_{k}_mesh"] for k in ("02", "04")},
          "reply_shape": one["reply_shape"], "eval_batch": EVAL_BATCH,
          "launches": counts["mesh_nccl"], "peak_gb": one["peak_gb"],
          "seconds": one["seconds"], "nondeterministic_ops": one["nondeterministic"]})
    counts["mesh_shared_card"] = shared_card_phase(shared, device)
    return counts


def shared_card_phase(shared, device):
    """``mesh_shared_card``'s checks and line, from its ranks' outputs
    (:func:`wait_mesh`); returns the mesh's own launches."""
    ranks = shared["ranks"]
    zero = ranks[0]
    for name, tol in MESH_REPLY_TOLERANCE.items():
        r = zero[name]
        check(r["max_abs_err"] <= tol * r["max_abs_ref"],
              f"mesh_shared_card {name}: reply error {r['max_abs_err']} > {tol} x "
              f"{r['max_abs_ref']}")
    for name, _, _, axes, b in MESH_SERVES:
        check(zero[name]["seq_parallel"] == (b < axes["data"]),
              f"mesh_shared_card {name}: sequence-parallel decode at batch 1 only")
        check(zero[name]["decomp_sharded"] == (name in MESH_DECOMP_SHARDED),
              f"mesh_shared_card {name}: ExtendedDINOSAUR sharded under model=2 only")
    for name in MESH_BF16_SERVES:  # tests/torch_bf16.py's rule
        e = zero[name]["bf16"]
        check(e["vs_one_process_bf16"] <= 2 * e["one_process_bf16_vs_f32"] + BF16_STEP
              and e["vs_one_process_f32"] <= 1.5 * e["one_process_bf16_vs_f32"] + BF16_STEP,
              f"mesh_shared_card {name}: bf16 reply against one process's: {e}")
    tp = ranks[1]["tp_step"]
    check(tp["loss_rel_err"] <= 1e-5, f"mesh_shared_card: TP 04 losses {tp}")
    check(tp["grad_norm_rel_err"] <= 1e-4, f"mesh_shared_card: TP 04 grad norm {tp}")
    check(tp["max_param_diff"] <= MESH_TP_PARAM_LRS * tp["lr"],
          f"mesh_shared_card: TP 04 parameters {tp['max_param_diff']} from world 1's "
          f"> {MESH_TP_PARAM_LRS} lr ({tp['lr']})")
    tp16 = ranks[1]["tp_step_bf16"]
    for k in ("loss", "grad_norm"):
        check(tp16[k] <= 2 * tp16[f"{k}_bf16_vs_f32"] + BF16_STEP,
              f"mesh_shared_card: bf16 TP 04 step's {k} against world 1's bf16: {tp16}")
    check(tp16["leaves"]["excess"] <= 0,
          f"mesh_shared_card: bf16 TP 04 step's leaves against world 1's bf16: {tp16}")
    check(all(r["excess"] > 0 for r in tp16["planted"].values()),
          f"mesh_shared_card: the bf16 TP leaf check passes a planted fault: {tp16}")
    q = zero["clip_int8_data2"]
    check(q["scales_rel_err"]["encode"] == 0
          and q["scales_rel_err"]["decode"] <= MESH_INT8_DECODE_SCALES_RTOL,
          f"mesh_shared_card: int8 scales at data=2 are not one process's: {q}")
    check(q["max_abs_err"] <= q["int8_error_of_one_process"],
          f"mesh_shared_card: int8 reply at data=2 further from one process's than int8 "
          f"from float: {q}")
    for key in ("tp_step", "tp_step_bf16"):
        check(ranks[0][key]["replicated_digest"] == ranks[1][key]["replicated_digest"],
              f"mesh_shared_card: {key}'s replicated leaves differ across the ranks")
    emergency = ranks[0]["tp_emergency"]
    check(emergency.get("joined_equals_gathered") is True
          and all(r["tp_emergency"]["files"] == emergency["files"] for r in ranks),
          f"mesh_shared_card: the emergency files under TP {[r['tp_emergency'] for r in ranks]}")
    check(all(r["backend"] == "gloo" for r in ranks), "mesh_shared_card: backend")
    counts = every_kernel({k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]})
    check(device != "cuda" or all(counts[k] > 0 for k in (
        "slot_attention", "conv5", "vit_attention", "conv_int8", "conv5_bf16",
        "vit_attention_bf16")), f"mesh_shared_card: launches {counts}")
    emit({"phase": "mesh_shared_card", "backend": "gloo", "world": 2, "card_shared": True,
          **{k: zero[k] for k in MESH_REPLY_TOLERANCE}, "clip_int8_data2": q,
          "reply_tolerance": MESH_REPLY_TOLERANCE,
          "int8_decode_scales_rtol": MESH_INT8_DECODE_SCALES_RTOL,
          "tp_step": {**tp, "replicated_bit_equal_across_ranks": True,
                      "param_limit_lrs": MESH_TP_PARAM_LRS, "batch": MESH_TP_BATCH,
                      "num_preds": MESH_TP_PREDS},
          "tp_step_bf16": {**tp16, "replicated_bit_equal_across_ranks": True,
                           "off_lrs": BF16_TP_OFF_LRS, "off_times": BF16_TP_OFF_TIMES,
                           "off_floor": BF16_TP_OFF_FLOOR},
          "mesh_preds": MESH_PREDS,
          "tp_emergency": emergency, "bf16": {n: zero[n] for n in MESH_BF16_SERVES},
          "bf16_rule": "2 e(one process bf16, float32) + 2**-8",
          "launches": counts,
          "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
          "processes_s": shared["processes_s"], "main_timeline_wait_s": shared["wait_s"],
          "seconds_by_rank": [r["seconds"] for r in ranks],
          "nondeterministic_ops": sorted({w for r in ranks for w in r["nondeterministic"]})})
    return counts


# ------------------------------------------------------------------ bfloat16
#
# tpu.compute_dtype "bfloat16" on both served experiments: each path's
# predictor experiment again as PRED_NAME_BF16, its params in bf16, the same
# random weights. The timed phases (one 8-row request through the live
# service a path; one 05 step on CATER) run on the idle card, each path's
# untimed checks of the card's bf16 outputs against its float32 ones (same
# weights, video, noise and captions) right after its service, and the
# port's CPU bf16 at batch 2 in the parity worker (finish_parities); beside
# mesh_shared_card's ranks they would slow the ranks' host work.

# card bf16 against card float32, of max |float32|: the seed's slots and
# reconstructed frames must lie in (lo, hi]; the predicted frames' largest
# and mean distances within PERF.md section 2's limits
BF16_SEED_RANGE = (1e-4, 5e-2)
BF16_PRED_MAX, BF16_PRED_MEAN = 0.5, 1e-2
BF16_PARITY_BATCH = 2


def bf16_experiment(exp_path: Path) -> str:
    """``exp_path``'s PRED_NAME again as PRED_NAME_BF16, computing in bf16
    (once); returns the name."""
    if not (exp_path / "predictors" / PRED_NAME_BF16).exists():
        quant_experiment(exp_path, PRED_NAME, PRED_NAME_BF16, "random", compute_dtype="bfloat16")
    return PRED_NAME_BF16


def bf16_kernel_entry(kernel, rows_, key, main_key, counts):
    """A kernel's ``bf16`` object of the ``kernels`` line: the row of its bf16
    variant where ``key`` is ``main_key`` (with the ReLU, where rows have
    one) at the top, every row below, and the launches of ``kernel`` on each
    path of ``counts``."""
    main = next(r for r in rows_ if r[key] == main_key and r.get("relu", True))
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
              "max_err_steps", "max_steps_vs_bf16_plain")
    return {**{k: main[k] for k in fields}, "shape": {key: main_key},
            "max_err_steps_all": max(r["max_err_steps"] for r in rows_), "tolerance_steps": 1,
            "launches": sum(c.get(kernel, 0) for c in counts.values()),
            "launches_by_path": {p: c.get(kernel, 0) for p, c in counts.items()},
            "rows": [{k: r[k] for k in (key, "relu", *fields) if k in r} for r in rows_]}


def phase_bf16_serve(path: ServedPath, exp_path: Path) -> dict:
    """The live service of ``path``'s served experiment in bf16: built and
    warmed up, then its main path, one 8-row request between a reset and a
    read of the counters (one slot-attention launch, and the bf16 conv5's
    three or the bf16 ViT attention's twelve), then two more requests and a
    stage split. Returns the main path's launches."""
    from textocvp_tpu_torch.serve import PredictionService

    name = bf16_experiment(exp_path)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    service = PredictionService(exp_path, name, "random", "random", batch_size=BATCH,
                                max_tokens=MAX_TOKENS, device="cuda")
    load_s = time.perf_counter() - t
    check(service.compute_dtype == "bfloat16", f"bf16_{path.name}: {service.compute_dtype}")
    service.warmup()
    video = np.random.default_rng(SEED).uniform(0, 1, (BATCH, 1, path.res, path.res, 3))
    video = video.astype(np.float32)
    captions = list(path.captions[:BATCH])
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    out = service.predict(video, captions)
    request_ms = 1e3 * (time.perf_counter() - t)
    counts = launches()  # and ends here
    want = every_kernel({"slot_attention": 1, "vit_attention_bf16": path.vit_per_request,
                         "conv5_bf16": path.conv5_per_request})
    check(counts == want, f"bf16_{path.name}: launches of a request {counts}, want {want}")
    check(out.shape == (BATCH, path.num_preds, path.res, path.res, 3)
          and bool(np.isfinite(out).all()) and out.min() >= 0 and out.max() <= 1,
          f"bf16_{path.name}: reply {out.shape}, [{out.min()}, {out.max()}]")
    inside = float(((out > 0) & (out < 1)).mean())
    check(inside >= 0.05, f"bf16_{path.name}: share of values inside (0, 1): {inside}")
    steady = []
    for _ in range(2):
        t = time.perf_counter()
        service.predict(video, captions)
        steady.append(1e3 * (time.perf_counter() - t))
    text = service._tokenize(captions)
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    pred_slots = service._predict_stage(video, text)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    service._decode_stage(pred_slots)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    check(pred_slots.dtype == torch.bfloat16, f"bf16_{path.name}: slots {pred_slots.dtype}")
    emit({"phase": f"bf16_{path.name}", "path": path.name, "compute_dtype": "bfloat16",
          "batch": BATCH, "num_preds": path.num_preds, "load_s": load_s,
          "request_ms": request_ms, "steady_8_row_ms": steady,
          "stage_ms": {"predict": 1e3 * (marks[1] - marks[0]),
                       "decode": 1e3 * (marks[2] - marks[1])},
          "unsaturated_share": inside, "launches": counts,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    del service, pred_slots
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_bf16_eval_step(exp_path: Path) -> dict:
    """One 05 step in bf16 at B=64, p=19 on the eval path's experiment (a
    warm step first), its launches between a reset and a read (one
    slot-attention launch, three bf16 conv5), its ms, predicted frames a
    second and peak memory. Returns the launches."""
    from textocvp_tpu_torch.train.evaluator import PredictorEvaluator

    ev = PredictorEvaluator(exp_path, bf16_experiment(exp_path), "random", "random",
                            num_seed=1, num_preds=EVAL_PREDS, batch_size=EVAL_BATCH)
    ev.load_data()
    ev.load_models()
    videos, info = next(iter(ev.test_loader))
    ev.eval_step(videos, info)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # the main path starts here
    t = time.perf_counter()
    vals = ev.eval_step(videos, info)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t)
    counts = launches()  # and ends here
    want = every_kernel({"slot_attention": 1, "conv5_bf16": 3})
    check(counts == want, f"bf16_cater_eval_step: launches {counts}, want {want}")
    check(all(bool(torch.isfinite(x).all()) for x in vals.values()), "bf16 05 metrics finite")
    emit({"phase": "bf16_cater_eval_step", "compute_dtype": "bfloat16", "batch": EVAL_BATCH,
          "num_preds": EVAL_PREDS, "step_ms": step_ms,
          "pred_frames_per_s": 1e3 * EVAL_BATCH * EVAL_PREDS / step_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "metrics_mean": {k: float(v.float().mean()) for k, v in vals.items()},
          "launches": counts})
    del ev, vals
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def served_models(exp_path: Path, pred_name: str, device):
    """The decomposition model and predictor of ``exp_path``'s predictor
    experiment ``pred_name`` (its compute dtype), their ``random`` weights,
    in ``eval()`` on ``device``."""
    from textocvp_tpu_torch.core.experiment import Experiment
    from textocvp_tpu_torch.models import setup_model, setup_predictor
    from textocvp_tpu_torch.train.checkpoints import load_params

    params = Experiment(exp_path / "predictors" / pred_name).params
    model = setup_model(params)
    model.load_state_dict(load_params(exp_path / "models" / "random.pt"))
    predictor = setup_predictor(params)
    predictor.load_state_dict(load_params(exp_path / "predictors" / pred_name / "models"
                                          / "random.pt"))
    return (model.to(device).eval().requires_grad_(False),
            predictor.to(device).eval().requires_grad_(False))


def bf16_outputs(model, predictor, video, noise, text, num_preds) -> dict:
    """The seed's slots and reconstructed frames and the predicted frames of
    ``video`` (B, 1, H, W, 3) from the initial slots' ``noise``, float32 on
    the CPU."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        init = model.slot_initializer(video.shape[0], noise=noise.to(dev))
        seed = model.decompose(video.to(dev), initial_slots=init)["slot_history"]
        frames = model.decoded(seed)["recons_imgs"]
        preds = predictor(seed, num_preds=num_preds,
                          **{k: v.to(dev) for k, v in text.items()})
        pred_frames = model.decode(preds.reshape(-1, *preds.shape[2:]))["recons_imgs"]
    return {k: v.float().cpu() for k, v in (("seed_slots", seed), ("seed_frames", frames),
                                             ("pred_frames", pred_frames.clamp(0.0, 1.0)))}


def bf16_cpu_half(spec_path, out_path):
    """The port's CPU bf16 outputs of a bf16 check's first BF16_PARITY_BATCH
    rows, in the parity worker."""
    spec = torch.load(spec_path, weights_only=False)
    model, predictor = served_models(Path(spec["exp"]), PRED_NAME_BF16, "cpu")
    torch.save(bf16_outputs(model, predictor, spec["video"], spec["noise"], spec["text"],
                            spec["num_preds"]), out_path)


def e_max(a, b, ref) -> float:
    """max |a - b| over max |ref|, of tensors or numpy arrays."""
    return float(abs(a - b).max() / abs(ref).max())


def phase_bf16_card(path: ServedPath, tmp: Path):
    """``path``'s bf16 outputs on the card against the card's float32 ones on
    the same weights, video, noise and captions (BATCH rows): the seed's
    slots and reconstructed frames within BF16_SEED_RANGE, the predicted
    frames within BF16_PRED_MAX and BF16_PRED_MEAN of max |float32|. Untimed.
    The first BF16_PARITY_BATCH rows go to the parity worker
    (``bf16_cpu_half``) here, and ``finish_parities`` holds the card's bf16 to
    the port's CPU bf16 there: each output within 2 e(bf16, float32) + 2**-8,
    the rule of the CPU tests (tests/torch_bf16.py), e(bf16, float32) the
    card's own distance on those rows. Returns the card's half, which
    ``main`` runs later, beside the shared card's ranks."""
    exp_path = tmp / path.name / "exp"
    gen = torch.Generator().manual_seed(SEED + 9)
    video = torch.rand((BATCH, 1, path.res, path.res, 3), generator=gen)
    _, pred_params = full_width_params(path)
    mp = pred_params["model"]["model_params"]
    noise = torch.randn((BATCH, mp["num_slots"], mp["slot_dim"]), generator=gen)
    text = caption_batch(pred_params, BATCH, path)
    bf16_experiment(exp_path)
    spec_path, out_path = tmp / f"bf16_{path.name}_spec.pt", tmp / f"bf16_{path.name}_cpu.pt"
    rows_ = slice(0, BF16_PARITY_BATCH)
    torch.save({"exp": str(exp_path), "video": video[rows_], "noise": noise[rows_],
                "text": {k: v[rows_] for k, v in text.items()}, "num_preds": path.num_preds},
               spec_path)
    t = time.perf_counter()
    job = parity_pool().apply_async(bf16_cpu_half, (str(spec_path), str(out_path)))
    return partial(_bf16_card_half, path, exp_path, video, noise, text, job, out_path, t)


def _bf16_card_half(path: ServedPath, exp_path, video, noise, text, job, out_path, t):
    """The card's half of ``phase_bf16_card``: its checks, its line, and the
    comparison with the CPU half deferred."""
    card = {}
    for dt, name in (("float32", PRED_NAME), ("bfloat16", bf16_experiment(exp_path))):
        model, predictor = served_models(exp_path, name, "cuda")
        card[dt] = bf16_outputs(model, predictor, video, noise, text, path.num_preds)
        del model, predictor
        torch.cuda.empty_cache()
    line = {}
    for k in ("seed_slots", "seed_frames"):
        d = e_max(card["bfloat16"][k], card["float32"][k], card["float32"][k])
        check(BF16_SEED_RANGE[0] < d <= BF16_SEED_RANGE[1],
              f"bf16_{path.name}: {k} card bf16 vs float32 {d} outside {BF16_SEED_RANGE}")
        line[k] = d
    pb, pf = card["bfloat16"]["pred_frames"], card["float32"]["pred_frames"]
    d_max, d_mean = e_max(pb, pf, pf), ((pb - pf).abs().mean() / pf.abs().max()).item()
    check(BF16_SEED_RANGE[0] < d_max <= BF16_PRED_MAX and d_mean <= BF16_PRED_MEAN,
          f"bf16_{path.name}: predicted frames card bf16 vs float32 max {d_max} "
          f"(limit {BF16_PRED_MAX}), mean {d_mean} (limit {BF16_PRED_MEAN})")
    line.update(pred_frames_max=d_max, pred_frames_mean=d_mean)
    mine = {dt: {k: v[:BF16_PARITY_BATCH * (path.num_preds if k == "pred_frames" else 1)]
                 for k, v in out.items()} for dt, out in card.items()}

    def finish():
        job.get(timeout=1800)
        waited = time.perf_counter() - t
        cpu = torch.load(out_path)
        out = {}
        for k, got in mine["bfloat16"].items():
            ref = mine["float32"][k]
            base = e_max(got, ref, ref)
            d = e_max(got, cpu[k], ref)
            limit = 2 * base + BF16_STEP
            check(d <= limit, f"bf16_{path.name}: {k} card bf16 vs CPU bf16 {d} > {limit}")
            out[k] = {"card_vs_cpu_bf16": d, "card_bf16_vs_float32": base, "limit": limit}
        return {"outputs": out, "cpu_half": {"waited_s_after_submit": waited}}

    defer_parity(f"bf16_{path.name}_parity", finish, path=path.name, batch=BF16_PARITY_BATCH,
                 rule="card bf16 within 2 e(card bf16, card float32) + 2**-8 of the CPU bf16, "
                      "of max |card float32|")
    emit({"phase": f"bf16_{path.name}_card", "path": path.name, "batch": BATCH,
          "of_max_float32": line, "seed_range": BF16_SEED_RANGE,
          "pred_frames_max_limit": BF16_PRED_MAX, "pred_frames_mean_limit": BF16_PRED_MEAN})


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
    check(counts == every_kernel({"slot_attention": requests,
                                  "vit_attention": requests * path.vit_per_request,
                                  "conv5": requests * path.conv5_per_request}),
          f"{path.name}: kernel launches on the main path: {counts}")
    phase_profile(path, service, video.astype(np.float32))
    del service
    torch.cuda.empty_cache()
    return counts


def conv5_bf16_backward_entry(rows_, counts) -> dict:
    """The bf16 conv5 backward in the ``kernels`` line: the input gradient
    (a launch of the bf16 kernel) at the 02 step's N and the 04 step's, and
    the weight gradient (``torch.matmul``) at the 02 step's, each with every
    key of a kernel's entry."""
    by_n = {r["N"]: r for r in rows_}
    train, frozen = by_n[TRAIN_BATCH * TRAIN_FRAMES * 8], by_n[PRED_TAIL_N]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "max_err_steps")
    return {
        "input_grad": {
            "name": "conv5_bf16_input_grad", "route": "cuda",
            "source": "textocvp_tpu_torch/csrc/conv5.cu",
            "replaces": "bench_pallas_conv.py:85 in bf16 (:32, :81-84): its input gradient",
            "launches": sum(c.get("conv5_bf16_input_grad", 0) for c in counts.values()),
            "launches_by_path": {p: c.get("conv5_bf16_input_grad", 0)
                                 for p, c in counts.items()},
            **{k: train["input_grad"][k] for k in keys}, "shape": {"N": train["N"]},
            f"n{frozen['N']}": {k: frozen["input_grad"][k] for k in keys},
            "tolerance_steps": 1,
            "library": "aten.convolution_backward bf16, input only (cuDNN, channels-last)"},
        "weight_grad": {
            "name": "conv5_bf16_weight_grad", "route": "torch.matmul",
            "source": "textocvp_tpu_torch/ops/conv5.py::conv5_weight_grad_bf16",
            "replaces": "none: the JAX package leaves this product to XLA",
            "launches": sum(c.get("conv5_bf16_weight_grad_calls", 0) for c in counts.values()),
            "launches_by_path": {p: c["conv5_bf16_weight_grad_calls"] for p, c in counts.items()
                                 if "conv5_bf16_weight_grad_calls" in c},
            **{k: train["weight_grad"][k] for k in keys}, "shape": {"N": train["N"]},
            "tolerance_steps": BF16_WEIGHT_GRAD_STEPS,
            "library": "aten.convolution_backward bf16, weight only (cuDNN, channels-last)"},
        "bias_grad_ms": train["bias_grad_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA device",
              file=sys.stderr)
        return 2

    name = phase_device()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fixtures = start_fixtures(Path(tmp))  # the CLIPort and PNG sets, host work only
        try:
            gmma = phase_build()
            rows = phase_kernels()
        except BaseException:
            stop_fixtures(fixtures)
            raise
        phase_host_io(Path(tmp), finish_fixtures(fixtures))
        made = phase_create(Path(tmp))
        counts = {path.name: run_path(path, Path(tmp)) for path in PATHS}
        bf16_card = []  # the CPU halves go to the parity worker now, the card's later
        for path in PATHS:
            counts[f"bf16_{path.name}"] = phase_bf16_serve(path, Path(tmp) / path.name / "exp")
            bf16_card.append(phase_bf16_card(path, Path(tmp)))
        run_export(Path(tmp))  # the artifacts load in a process of their own meanwhile
        counts["serve_batching"] = phase_serve_batching(Path(tmp) / PATHS[0].name / "exp")
        counts["eval"] = run_eval(Path(tmp))
        counts["bf16_cater_eval_step"] = phase_bf16_eval_step(Path(tmp) / "eval" / "exp")
        (counts["train"], train_input_grad, train_exp, counts["bf16_train_step"],
         untimed) = run_train(Path(tmp))
        # 03 on the SAVi that 02 wrote, over the eval path's 128 test videos
        counts["decomp_eval"] = run_decomp_eval(
            "cater", made["cater"], train_exp / "models" / "checkpoint_epoch_final.pt",
            Path(tmp) / "CATER", EVAL_VIDEOS)
        counts[RESNET_NAME] = phase_resnet_savi(Path(tmp), Path(tmp) / PATHS[0].name / "exp")
        counts["conv_decoder_tails"] = phase_conv_decoder_tails()
        phase_train_extras(Path(tmp))
        phase_train_remat(train_exp, Path(tmp) / "CATER_train")
        (counts["pred_train"], pred_input_grad, pred_weight_grad,
         counts["bf16_pred_train_step"], pred_untimed) = run_pred_train(train_exp)
        untimed += pred_untimed
        counts.update(run_figs(train_exp, Path(tmp)))
        # the mesh phases' processes import beside the phases before start_mesh
        mesh = spawn_mesh(Path(tmp))
        other_counts, other_input_grad, other_weight_grad, other_parities = run_predictors(
            Path(tmp), train_exp)
        counts.update(other_counts)
        untimed += other_parities
        # mesh_shared_card's two ranks beside phases that time nothing: the
        # trainer parities' card halves (float32 and bf16), the bf16 services
        # against their float32 ones, the CATER sign checks
        mesh = start_mesh(mesh, Path(tmp), train_exp)
        try:
            clip_data, clip_exp = clip_fixture(Path(tmp))
            for phase in bf16_card + untimed:
                phase()
            clip_parent = clip_random_parent(Path(tmp))
            phase_clip_pred_train_parity(clip_parent)
            phase_bf16_parities(Path(tmp), train_exp, clip_parent)
        finally:
            wait_mesh(mesh)  # and done before the timed phases after it
        png_root, clip_png_root = Path(tmp) / "CATER_png", Path(tmp) / "CLIPort_png"
        counts["png_eval"] = run_png_eval(Path(tmp), png_root)
        counts.update(run_clip(Path(tmp), made["clipport"], clip_data, clip_exp))
        counts.update(run_quant(Path(tmp), Path(tmp) / "eval" / "exp", Path(tmp) / "clip_train"))
        counts.update(run_clip_figs(Path(tmp) / "clip_train"))
        phase_clip_remat(Path(tmp) / "clip_train")
        counts["clip_png_eval"] = run_clip_png_eval(Path(tmp), clip_png_root)
        finish_parities()  # the trainer parities' CPU halves, checked; their lines
        counts.update(finish_exports())  # the artifacts answer on the idle card
        counts.update(run_mesh(mesh))  # mesh_nccl alone on the card, then the shared card's

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
    bf16_entry = partial(bf16_kernel_entry, counts=counts)

    int8_rows = {r["case"]: r for r in rows["conv_int8"]}
    int8_eval = int8_rows["savi_eval"]
    emit({"kernels": [{
        "name": "slot_attention",
        "route": "cuda",
        "source": "textocvp_tpu_torch/csrc/slot_attention.cu",
        "replaces": "textocvp_tpu/ops/pallas/slot_attention_kernel.py:37",
        "launches": sum(c["slot_attention"] for c in counts.values()),
        "launches_by_path": {p: c["slot_attention"] for p, c in counts.items()},
        "max_abs_err": max(max(r["max_abs_err_slots"], r["max_abs_err_attn"]) for r in
                           rows["slot_attention_cater"] + rows["slot_attention_clipport"]
                           + rows["slot_attention_resnet"]),
        "ms": sa["ms"],
        "plain_ms": sa["plain_ms"],
        "bound_ms": sa["bound_ms"],
        "bound_by": sa["bound_by"],
        "library_ms": None,
        "cluster_size": sa["cluster_size"],
        "active_clusters": sa["active_clusters"],
        "device_launches_per_call": max(
            r["device_launches"] for r in rows["slot_attention_cater"]
            + rows["slot_attention_clipport"] + rows["slot_attention_resnet"]),
        **{name: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
           | {"max_abs_err": max(r["max_abs_err_slots"], r["max_abs_err_attn"])}
           for name, r in (("b64", sa64), ("b1", sa1))},
        "resnet_grid": {f"b{r['B']}_{r['iters']}it": {k: r[k] for k in (
            "N", "S", "mlp", "ms", "plain_ms", "bound_ms", "bound_by")}
            | {"max_abs_err": max(r["max_abs_err_slots"], r["max_abs_err_attn"])}
            for r in rows["slot_attention_resnet"]},
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
        "bf16": {**bf16_entry("vit_attention_bf16", rows["vit_attention_bf16"], "B", BATCH),
                 "design": "wgmma m64n64k16 + TMA ring on mbarriers",
                 "sass_hgmma": gmma["attention_bf16_kernel"]},
    }, {
        "name": "conv5",
        "route": "cuda",
        "source": "textocvp_tpu_torch/csrc/conv5.cu",
        "replaces": "bench_pallas_conv.py:85",
        "launches": sum(c["conv5"] for c in counts.values()),
        "launches_by_path": {p: c["conv5"] for p, c in counts.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows["conv5"] + rows["conv5_upsample"]),
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
        "upsample_variant": {f"{r['H']}px": {k: r[k] for k in (
            "N", "relu", "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_fp32_cores",
            "library_ms", "max_abs_err")} for r in rows["conv5_upsample"]},
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
        "bf16": {**bf16_entry("conv5_bf16", rows["conv5_bf16"], "N", EVAL_BATCH * EVAL_PREDS * 8),
                 "design": "wgmma m64n256k16 (weights A, halo B) + TMA halo and weight rings, "
                           "persistent, warp-specialised",
                 "sass_hgmma": gmma["conv5_bf16_kernel"],
                 "backward": conv5_bf16_backward_entry(rows["conv5_bf16_backward"], counts)},
    }, {
        "name": "conv_int8",
        "route": "cuda",
        "source": "textocvp_tpu_torch/csrc/conv_int8.cu",
        "replaces": "none: the int8 decode's conv, which the JAX package leaves to XLA "
                    "(textocvp_tpu/nn/decoders.py:220, ConvDecoder._quantize_conv)",
        "launches": sum(c["conv_int8"] for c in counts.values()),
        "launches_by_path": {p: c["conv_int8"] for p, c in counts.items()},
        "max_abs_err": max(r["max_abs_err"] for r in rows["conv_int8"]),
        "ms": int8_eval["ms"],
        "plain_ms": int8_eval["plain_ms"],
        "bound_ms": int8_eval["bound_ms"],
        "bound_by": int8_eval["bound_by"],
        "library_ms": None,
        "design": "wgmma m64nNk32 .s8 + TMA halo ring, persistent, warp-specialised",
        "sass_igmma": gmma["conv_int8_kernel"],
        "float_path": int8_eval["float_path"],
        "shape": [int8_eval["N"], int8_eval["H"], int8_eval["W"], int8_eval["Cin"],
                  int8_eval["Cout"], int8_eval["k"]],
        **{case: {k: r[k] for k in ("N", "H", "W", "k", "Cin", "Cout", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "float_path", "max_abs_err")}
           for case, r in int8_rows.items() if r is not int8_eval},
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
