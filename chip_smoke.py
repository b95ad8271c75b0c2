#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``m3f_torch``) on one GPU.

Run from the repository root with no arguments on a machine with an NVIDIA
H100 (``python3 chip_smoke.py``). It

1. prints the card (``nvidia-smi`` name and power limit) and builds every
   kernel of the serving path from ``m3f_torch/csrc`` (one ``nvcc`` per
   source, all at once);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the full-width ``longseq_eval`` forward gives it, and times the
   plain version with CUDA events (median of 20) and the kernel and one
   PyTorch yardstick call in turn (5 rounds of 20: the median of the round
   medians and their spread); the conv units' channel sums are held per
   channel, and the same check is shown to refuse a zeroed,
   channel-shifted or last-partial-step-short (temporal: last-partial-
   strip-short) s1; the spatial unit's y check is shown to refuse a y whose
   zero padding went through the prologue and a y from the filter with dh
   and dw swapped, the temporal unit's a y whose zero frames at the clip
   edges went through the prologue, a y from the filter with taps 0 and 2
   swapped and a y whose clips read their neighbours' frames; two calls
   must give the same bits; the mel kernel, one mixed-radix FFT walk for
   every n_fft, is held fp32 and bf16 out, static and per-row hop, and
   timed at n_fft 1024 and 400 (not a power of two), held untimed at
   MEL_CHECK_N_FFT and the largest n_fft its plan takes (both layouts:
   everything in shared memory, or the FFT buffers and tables in device
   memory), and shown to refuse the next ones before a launch; then checks each kernel at shapes
   off the main path's tiling (FWD_EDGE_SHAPES: images smaller and larger
   than a step, W not dividing it, partial chunks, masked channels, the
   filter resident and streamed; clips of 1-7 frames, partial strips and
   strips across clips; widths that are not multiples of 8, which the
   wrappers zero-pad; mel rows with a partial last frame block or fewer
   frames than a block at n_fft 1024, 401 and 4096 for both hops, and a
   per-row hop above max_hop_length, which takes another layout; the GRU at GRU_EDGE_SHAPES, each on its planner's route). The GRU is held on both
   of its routes, the cluster walk (which the serving shape must take) and
   the stream route (the first design), and timed in turn with the stream
   route, the port's layer (input projection, then the kernel) and
   ``nn.GRU`` on the same input, and at the train step's shape;
   The four backward kernels of the conv units (data and filter gradient,
   spatial and temporal) are held the same way at the fusion train step's
   shapes: dx per element (one bf16 ulp, carried through inv), dw per
   element (1e-5 of sum |x^|*|ge|), dinv / dshift per channel; each check
   is shown to refuse a zeroed dinv, a dw one channel off, a dw with taps
   0 and 2 swapped (along dt or dh, and along dw), a dx with the walk's
   last step (spatial: the row walk's last step of pixels; temporal: the
   frame walk's last unit) left out, a dx from the filter with taps 0 and
   2 swapped (along dt; spatial: along h, and along w) and a dw without its
   last slice's partial; every gradient must repeat its dx, dinv, dshift
   and dw bit for bit; they are timed beside their plain versions
   and cuDNN's backward (``torch.nn.grad.conv3d_input`` / ``conv3d_weight``)
   and checked again at shapes off the tiling (short clips, partial
   strips, masked channels, images of one row, one column or one pixel,
   k-steps that span rows and images, widths that are not multiples of
   8); the temporal forward is held at the train shapes as well;
   The fp32 conv units (rows 3f / 4f, ``csrc/conv_bn_f32.cu``: row 3f the
   row walk ``spatial_fwd_f32_kernel``, row 4f the frame walk
   ``temporal_fwd_f32_kernel``; phase ``kernel_conv_f32``, with the plan:
   the spatial step, N tile, K chunk and ranges, the temporal strip, N
   tile, K chunk, register tile and resident or streamed filter) are held
   against their plain versions at every
   fused unit's serving shape of ``longseq_eval`` with
   ``compute_dtype=float32``, at F32_EDGE_SHAPES (partial position and
   channel tiles, 1x1 images, one frame, widths the wrapper zero-pads),
   at F32_WALK_EDGE_SHAPES (7x7 images several a step with the last range
   not full, C_out 200, 1152 in N tiles of 144, 256 in tiles of 128), at
   F32_GATHER_EDGE_SHAPES (images too wide for the row walk: the spatial
   kind through the per-tap gather) and at F32_FRAME_EDGE_SHAPES (one
   frame, strips across 7x7 clips, C_out 200, the stage-4 train shape with
   fewer strips than SMs),
   y per element within CONV_F32_REL of sum |x^|*|w| plus CONV_F32_ABS, the
   sums per channel; each check is shown to refuse a y from swapped taps,
   a y whose padding went through the prologue, a y whose prologue rounds
   once (a fused multiply-add, seen on a clip where the two roundings
   cancel exactly), a y whose clips read their neighbours' frames (the
   temporal kind), a zeroed or shifted s1 and an s1 without the last
   range's share (the walks' ranges of images or strips; within one range
   its last partial step or strip); two calls give the same bits; timed
   beside the plain
   version and cuDNN's fp32 conv (no TF32) plus the sums. Rows 3-8 are held
   at the lane midplanes 128 / 256 / 512 / 1152 (phase ``kernel_lane``:
   the forward at the serving shapes, the backward at the train shapes);
   the fp32 backward kernels (rows 5f-8f, ``csrc/conv_bn_f32.cu``, phase
   ``kernel_conv_f32_bwd``; row 5f the row walk
   ``spatial_data_f32_kernel``, row 6f the row walk
   ``spatial_filter_f32_kernel``, row 7f the frame walk
   ``temporal_data_f32_kernel``, row 8f the frame walk
   ``temporal_filter_f32_kernel``, their plans in every phase line) are
   held against their plain versions (TF32 off) at F32_EDGE_SHAPES,
   F32_FILTER_WALK_EDGE_SHAPES (images two a slice with a one-image last
   slice, C_out 200, C_in 24, 1x1 images, the stage-4 train shape),
   F32_DATA_WALK_EDGE_SHAPES (images four a range with a one-image last
   range, C_in 200, C_out 40, 1x1 images several a step, the stage-3 and
   stage-4 train shapes with their K splits), F32_TEMPORAL_DATA_EDGE_SHAPES
   (one-frame clips, 7x7 clips across strips with a partial last strip at
   C_in 200 and C_out 40, C_out 200, the stage-4 train shape, and
   F32_TEMPORAL_DATA_144_SHAPES: N tiles of 144 with a partial last
   strip, a masked tile and ranges of two strips),
   F32_TEMPORAL_FILTER_EDGE_SHAPES (one-frame clips, 7x7 clips across
   strips, C_in 40, 200 and 280 in partial channel blocks, C_out 40, 22
   slices with a short last, the stage-4 train shape, and
   F32_TEMPORAL_FILTER_64_SHAPES: channel blocks of 64 with a partial last
   strip, an idle warp and a masked N tile; every temporal shape must take
   the filter gradient's frame walk; an empty batch must give a zero dw)
   and
   F32_GATHER_EDGE_SHAPES (both spatial gradients of images too wide for
   the row walks through the per-tap gathers; phase
   ``kernel_conv_f32_bwd_edges``) and at every
   fused unit's shape of the fusion train step: dx per element within
   BWD_F32_REL of (|ge| (*) |w| mirrored) through the mask and |inv|, dw
   per element within 1e-5 of sum |x^|*|ge|, dinv / dshift per channel;
   each check is shown to refuse the plain version under TF32 (at the train
   shapes), a dw without its last slice's share, a dinv without its last
   partial row, swapped taps, and at the edge shapes a dx whose ge went
   through the formula in the padding and a dw whose x^ went through the
   prologue there; two calls give the same bits; timed beside the plain
   version and cuDNN's fp32 ``conv3d_input`` / ``conv3d_weight``;
   The four kernels of the packed-layout conv probe (packed_conv with bf16
   and fp32 y and packed_conv_chunked, both the TMA-fed wgmma walk;
   ablate_slabs, ablate_matmul) are held against their plain versions at
   the probe's full shape (COUT 144, timed beside the plain versions,
   ``F.conv2d`` and ``torch.matmul``; and COUT 128), at two shapes off the
   tiling and at COUT 264 (two N passes, 140 units: the persistent grid's
   last wave partial), each check shown to refuse a y with its tail
   columns zeroed and a y without the x-edge masks (for the product
   ablation, a y with its last image left out), and each of the four held
   on an input one element off 16 bytes (copied to aligned storage for the
   copy engine), against the y of the inputs shifted by one; then the probe
   runs every phase at full shape (``probe_packed_conv.run``) with the
   counters set to 0 just before and read just after, each of its four
   kernels launched, packed_conv and packed_conv_chunked within 2e-2 of
   ``reference_conv`` (COUT 144 and 128);
3. serves a synthetic 1024-frame video through ``Predictor(preset=
   "longseq_eval")`` at full width with seeded random weights: a 30 fps
   request, a 25 fps request (per-video mel hop) and a chunked one
   (``window.eval_max_windows=64``), each with the launch counters set to 0
   just before and read just after; every kernel must have launched; then
   ``predict_many`` over 3 videos with 2 in flight, each bit for bit
   ``predict_video``'s, timed beside the serial loop; then the same weights
   with ``model.mel.n_fft`` = ``win_length`` = 400, whose request must
   launch the same kernels as the 30 fps one;
   then the live-serving path on the same weights: ``Predictor.warmup``
   (every input shape of a video up to 1024 frames, nominal and at 25 fps)
   and ``SessionGroup.warmup``, timed; the 1024-frame video pushed a second
   at a time through ``Predictor.stream`` at 30 and at 25 fps, covering
   every frame once and in order, within STREAM_ATOL / STREAM_MEAN_ATOL of
   its ``predict_video`` (push latency p50 / p99); 16 sessions fed tick by
   tick through ``SessionGroup.push_many`` so that every batch bucket 1-16
   occurs, beside two sessions at 25 and 27 fps batched at their own mel
   hops, each within the same limits of its own ``predict_video``; an
   in-process ``PredictServer``: ``/predict`` with an x-npy answer bit for
   bit ``predict_video``'s, 4 concurrent HTTP streams within the limits,
   ``/statz``; and ``utils.profiling.trace`` around one served video
   (device time by kernel and by the host op that launched it, beside the
   host time; the four forward kernels must be among its device events);
   the stream and group phases set the counters to 0 just before and
   require every forward kernel launched; then checkpoint ensembles of the
   same preset (phase ``serve_ensemble``): two members,
   ``Trainer.commit_state(..., eval_only=True)`` snapshots of the seed-0
   and seed-1 inits; ``predict_ensemble`` of [a] and of [a, a] must repeat
   a's single prediction of the 1024-frame video bit for bit, and of
   [a, b] the float64 mean of the two single tracks, with the counters set
   to 0 just before it and exactly twice a served video's launches after;
   ``evaluate_ensemble([a, b])`` over ``serve_many``'s three videos
   (labels from seeds, a span invalid; phase ``eval_ensemble``): two
   models, finite metrics, and ``write_submission`` into
   ``build/submission/``, one file a video of 1025 lines;
3d. serves every visual backbone of the reference at full width (phase
   ``serve_backbones``: ``longseq_eval`` with ``conv_mode=3d``,
   ``conv_mode=mc3``, ``se_ratio=16``, ``stem_s2d=true``,
   ``mid_mode=lane`` or ``compute_dtype=float32``): the 1024-frame video
   after a warm run (frames/s, peak memory), launches held to the
   configuration's fused blocks (the fp32 one through rows 3f / 4f), and
   each card against CPU on a 48-frame video of 32x32 frames (bf16 within
   the serving limits, fp32 within F32_PATH_ATOL / F32_PATH_MEAN_ATOL and
   its backbone features within F32_FEAT_REL, which the same features
   with TF32 on in cuDNN must exceed);
4. runs the same weights of a narrow model through the port on the CPU
   (plain versions) and on the card (kernels) and compares the predictions;
5. trains the full-width ``fusion`` preset (R(2+1)D-18, batch 8 x 4
   windows x 16 frames of 112x112, seeded random weights, synthetic data)
   through ``Trainer.fit``: 2 warm steps, then a second fit of 10 steps
   (from the seed again) with the counters set to 0 just before; each
   kernel must have launched exactly its per-step count times 10, loss and
   grad norm must be finite and the params must move (s/step between the
   ends of the first and last step, clips/s, peak memory); the same preset
   with ``model.dropout=0.1`` and ``data.augment=true`` (phase
   ``train_fusion_options``): 10 steps with exactly the same launches, a
   finite loss that differs from the plain fit's, and a second fit from
   the seed repeating its losses bit for bit (step time beside the plain
   one's); ``model.init_from`` (phase ``init_from``): an ``r2plus1d``-kind
   file written from the seed-0 model's ``visual.*``, loaded by a trainer
   seeded 1, whose step-0 ``visual.*`` must be the file's and every other
   tensor its own seed's; then 3 steps of a narrow model on the CPU and
   on the card, from the same weights and batches, compared; two
   full-width fusion steps of each bf16 backbone of phase serve_backbones
   (phase ``train_backbones``: finite losses, their launches, s/step, peak
   memory; the fp32 one through the fp32 backward kernels, none of the bf16
   ones); and full-width fusion with ``compute_dtype=float32`` through
   ``Trainer.fit`` (phase ``train_fp32``: 2 warm steps, then 4 with the
   counters set to 0 just before, each fp32 kernel of rows 3f-8f launched
   10 times a step and no bf16 conv kernel, finite losses, s/step, peak
   memory); ``train_parity`` also trains the narrow model in fp32 on the
   card against the CPU (through rows 3f-8f) beside the CPU's own fp32 run
   on a video one part in 1e7 off;
5b. the data layer and the command line: the port's JPEG loader built from
   ``csrc/loader.cc`` for this host (phase ``data_loader``: 1024 decodes
   of the committed fixtures plus a missing and a corrupt file, each frame
   within LOADER_TOL of the committed reference decode, frames/s);
   a fake ABAW tree under ``build/abaw_fake/`` made of fixture copies,
   PCM16 wavs and annotations with -5 rows (a 25 fps video, a 60 ms wav
   tail, a test split with a gap); then ``m3f_torch.main`` as a user runs
   it: ``doctor`` (only the 25 fps video off-rate), ``train`` of the
   full-width ``fusion`` preset from the JPEGs (8 hop-aware steps, every
   kernel of rows 1-8 launched, the backward ones 10 a step, checkpoints,
   a trace; 4 steps resumed; 2 from ``--resume-from``) with the input
   timed alone, ``inspect``, ``profile``, ``eval`` of a checkpoint and of
   a two-member ensemble, ``predict`` of the test split, ``export
   --format torch`` and the import script (a video predicted bit for bit
   alike), ``serve`` as a process of its own (``/predict`` against the
   in-process prediction, SIGINT, exit 0), 2 steps each of ``audio_only``
   and ``visual_only`` (their launches) and ``train.debug_nans`` (a NaN in
   the second batch raises at step 2);
5c. the data axis and the reference's checkpoint layout (``parallel/``):
   ``resume_jax_layout`` (full-width ``fusion``, 2 steps saved in the
   layout of the JAX package's optax chain, resumed by a fresh ``Trainer``
   for 2 more, held against 4 uninterrupted steps within RESUME_LOSS_ATOL
   and RESUME_PARAM_REL); ``ddp_train`` (``m3f_torch.main train --preset
   distributed_train`` in this process under torchrun's variables at world
   size 1 over NCCL: s/step, peak memory, every collective through the
   group); ``ddp_two_ranks`` (this script twice more, ``--ddp-rank``, two
   gloo ranks on the one card with 16 of the 32 clips each, against the
   same steps in one process without a group, within DDP_LOSS_RTOL,
   DDP_GNORM_RTOL and DDP_LATER_LOSS_ATOL, the ranks bit-equal, their
   BatchNorm running means too; beside it the one
   process on the batches with their clips reversed (the spread of another
   summation order alone) and, as witnesses, both ranks on the same 16
   clips against one process on those 16 (DDP_WITNESS_*) and the eval
   forward of 16 sequences in a batch of 32 against alone; each fault of
   DDP_FAULTS planted in the ranks must break a limit; whole-video eval
   and the sequence forward of DDP_EVAL_SEQS sequences sharded over the
   ranks against one process within DDP_EVAL_ATOL);
5d. the model axis (phase ``tp_ranks``): this script four more times
   (``--tp-rank``), four gloo ranks on the one card as a 2 x 2 mesh of
   ``distributed_train`` (TP_CLIPS clips a data row; the BiGRU
   column-parallel, the fusion head row-parallel, each rank holding its
   blocks of them, their moments and EMA), 3 steps against world size 1 on
   the same global batches within TP_LOSS_RTOL, TP_GNORM_RTOL and
   TP_LATER_LOSS_ATOL, the replicated leaves bit-equal on all ranks and
   the blocks within each column, every kernel of rows 1-8 launched; the
   ranks' checkpoint after step TP_CKPT_STEP resumed at world size 1 with
   every array the ranks held, bit for bit, and its next step within
   TP_LATER_LOSS_ATOL of theirs; each fault of TP_FAULTS planted in the
   ranks must break a limit or leave them disagreeing; the
   sequence-parallel BiGRU at TP_SEQ (bf16, the fp32 carry sent between
   the ranks of each data column) against the unsharded layer, output
   within TP_SEQ_ATOL and gradients within TP_SEQ_GRAD_REL, two ``gru``
   launches a rank, its times beside the unsharded layer's. ``check_gru``
   also holds the kernel's carried state at the serving shape
   (``check_gru_carry``: a nonzero h0, a zero h0 bit-equal to none, a lane
   cut into two launches chained by the fp32 carry bit-equal to one, both
   routes, bf16 and fp32);
6. prints the ``kernels`` line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero. Without a GPU, or without the package next
to this file, it exits non-zero before printing any result. TF32 is off for
every comparison.
"""

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

# Tolerances, stated before the run:
MEL_ATOL = 5e-3          # log domain, fp32 (tests/test_melspec_pallas.py:41);
#                          bf16 out: that plus one bf16 ulp of the plain
#                          value (each side rounds its fp32 value once)
GRU_ATOL_F32 = 1e-5      # fp32 recurrence (tests/test_gru_pallas.py:21-22)
GRU_ATOL_BF16 = 2 ** -6  # bf16 x/W: a bf16 round of h@W_hh can flip by one
#                          ulp with the fp32 summation order (4 ulps at |h|=1)
CONV_Y_REL = 2 ** -7     # bf16 y: one ulp from the fp32 summation order ...
CONV_Y_ABS = 1e-5        # ... plus a floor, relative to max|y|, near zero
CONV_S_REL = 1e-5        # channel sums, per channel: fp32 summation order,
#                          relative to sum|y| and to s2 (see sum_limits)
# bf16 dx per element (BWD_DX_ABS): one ulp (the fp32 summation
#                          order of dx^); with the prologue, that ulp of dx^
#                          carried through the scale by |inv| plus two ulps
#                          of dx for the two roundings of dxa*inv (half an ulp
#                          each, a whole one above a power of two) ...
BWD_DX_ABS = 1e-5        # ... plus a floor, relative to max|dx|, near zero
BWD_DW_REL = 1e-5        # fp32 dw per element: 1e-5 of sum|x^|*|ge| (fp32
#                          summation order over up to 1.6 M pixels) ...
BWD_DW_ABS = 1e-6        # ... plus a floor, relative to max of that sum
BWD_S_REL = 1e-5         # dinv/dshift per channel: the dx^ differences held
#                          above, carried (sum|x|*|dxa - dxa_ref|), plus 1e-5
#                          of sum|x*dxa_ref| for the fp32 summation order
PROBE_F32_REL = 1e-5     # packed conv fp32 y per element: 1e-5 of |W_cm|@|P|
#                          (fp32 summation order over K = 576) ...
PROBE_ABS = 1e-6         # ... plus a floor; bf16 y (conv, chunked, product
#                          ablation): one bf16 ulp of the fp32 value on top;
#                          the slab ablation bit for bit (a copy, a x0 / x1)
PROBE_REF_REL = 2e-2     # packed conv vs reference_conv, max|dy| / max|y| over
#                          the first HW positions (probe_packed_conv.py:333)
PROBE_ITERS = 10         # timed calls per phase of the probe's own run
PATH_ATOL = 3e-2         # whole-path bf16 preds (tanh outputs), card vs CPU
PATH_MEAN_ATOL = 5e-3
CHUNK_ATOL = 3e-2        # fused vs chunked eval of one video on the card
TRAIN_LOSS_ATOL = 1e-2   # narrow training (a two-stage R(2+1)D, 3 SGD
#                          steps), card vs CPU, per-step loss; at this size
#                          the CPU's own bf16 vs fp32 run moves the losses
#                          by <= 3.6e-3 (measured on the CPU before the
#                          card run), and the phase reports that gap beside
TRAIN_PARAM_REL = 0.5    # ... and |params_card - params_cpu| (L2) within
#                          half the L2 norm of the CPU run's param move
#                          (bf16 vs fp32 on the CPU: 0.23): a random-init
#                          net training on batch statistics amplifies
#                          one-ulp differences of its bf16 convs

STREAM_ATOL = 1e-2       # a live stream (one W-window sequence a forward,
STREAM_MEAN_ATOL = 1e-3  # or a SessionGroup batch of 1-16) against the same
#                          video's predict_video (16 sequences a forward) on
#                          the card, bf16: the two batchings may differ only
#                          by the batch's effect on the summation order of
#                          cuDNN's convs and the GEMMs (a bf16 ulp of an
#                          activation here and there, carried to the tanh
#                          outputs), well inside the 3e-2 / 5e-3 that hold
#                          the card against the CPU's different arithmetic
# fp32 conv units (rows 3f / 4f), fixed before their first run on the card:
CONV_F32_REL = 1e-5      # y per element: 1e-5 of sum |x^|*|w| over the
#                          output's taps (fp32 sums in another order, K up to
#                          10368) ...
CONV_F32_ABS = 1e-30     # ... plus a floor for products that underflow: an
#                          output whose every product is 0 must be 0 (the
#                          fused mul-add prologue control lives there)
F32_FWD_ROUNDS, F32_FWD_REPS = 3, 5   # timed_alternating for the fp32 units
F32_PATH_ATOL = 1e-4     # fp32 serving preds (tanh outputs), card vs CPU:
F32_PATH_MEAN_ATOL = 1e-5   # 300x tighter than bf16's 3e-2 / 5e-3 (the
#                          CPU's fp32 vs float64 run: 2.2e-8 max at this size)
F32_FEAT_REL = 5e-5      # fp32 backbone features, card vs CPU, max |diff| /
#                          max |feature|: the CPU's fp32 vs float64 run moves
#                          them by 3.5e-7-5.4e-7 of their largest, a TF32
#                          emulation of the library convs by 4.8e-4-6.3e-4
#                          (every family, measured on the CPU before the card
#                          run); the phase shows TF32 on the card exceeds it
# fp32 conv-unit backward (rows 5f-8f), fixed before their first run on the
# card:
BWD_F32_REL = 1e-5       # dx per element: 1e-5 of (|ge| (*) |w| mirrored)
#                          through the mask and |inv| (fp32 sums in another
#                          order, K up to 10368) ...
BWD_F32_ABS = 1e-30      # ... plus a floor for sums whose every product is 0;
#                          dw per element: BWD_DW_REL of sum |x^|*|ge| plus
#                          BWD_DW_ABS of its largest, and dinv / dshift per
#                          channel BWD_S_REL, as the bf16 backward (dw is fp32
#                          on both routes)
F32_BWD_ROUNDS, F32_BWD_REPS = 3, 5   # timed_alternating for rows 5f-8f
F32_TRAIN_STEPS = 4      # phase train_fp32: fit steps after 2 warm ones
F32_TRAIN_LOSS_ATOL = 1e-3   # narrow fp32 training, card vs CPU, per-step
F32_TRAIN_PARAM_REL = 0.15   # loss, and params (L2) within 0.15 of the CPU
#                          run's move: the same 3 steps on the CPU with each
#                          pixel of the video one part in 1e7 off (a random
#                          sign each) move the losses by up to 1.5e-4 and
#                          the params by 0.034-0.043 of the move (measured on
#                          the CPU before the card run; the phase repeats that
#                          run beside the card's): a random-init net on batch
#                          statistics through the CCC loss amplifies any
#                          rounding difference. Both stay under the CPU's
#                          bf16-vs-fp32 gap (3.6e-3, 0.23 of the move), so
#                          the check tells the two dtypes apart
HTTP_STREAMS = 4         # concurrent HTTP streams in phase http_server
TRACE_TOP = 15           # rows of the trace summary printed

PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor rate, FLOP/s
PEAK_FP32 = 67e12        # H100 SXM fp32 rate outside the tensor cores
HBM = 3.35e12            # H100 SXM memory rate, B/s


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def require(cond, msg):
    if not cond:
        fail(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


SPIN_CYCLES = 2_000_000  # ~1 ms of torch.cuda._sleep, longer than a call's
#                          host work


def timed(torch, fn, reps=20):
    """Median ms of ``reps`` calls, each between two CUDA events and queued
    behind a spin kernel: the host has launched the whole call before the
    first event is reached, so the events time the device alone, not the
    host's launch work (which inflated short kernels' times before)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


ROUNDS = 5               # rounds of ALT_REPS calls, kernel and library in turn
ALT_REPS = 20


def timed_alternating(torch, fns, rounds=ROUNDS, reps=ALT_REPS):
    """``fns`` = {name: fn}, timed in turn: each round times every fn as
    ``timed`` does (median of ``reps``), one after the other. Returns {name:
    (median of the round medians, spread = largest - smallest round
    median)}: a kernel and its library call timed under the same load."""
    per = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            per[name].append(timed(torch, fn, reps))
    return {name: (statistics.median(v), max(v) - min(v))
            for name, v in per.items()}


def bound(nbytes, flops, peak):
    """The least time for the work: ``nbytes`` at the memory rate or
    ``flops`` at ``peak``, the larger. ``flops`` counts what the function
    needs on these inputs (a conv unit: 2·C_in·C_out a
    ``conv_bn.tap_pairs`` pair; the zero padding needs none)."""
    t_bytes, t_ops = nbytes / HBM * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# n_fft the mel kernel is held at without timing, beside the timed 1024 and
# 400 (and the largest its plan takes): the 20 and 30 ms speech windows,
# radix 7, one prime stage of 499, an odd prime, the first above 2048, an
# odd one (3 59 113) whose FFT buffers and tables are in device memory
MEL_CHECK_N_FFT = (320, 480, 448, 998, 401, 4096, 20001)


def mel_rows(n_fft):
    """(rows, static samples, per-row-hop samples, per-row-hop frames): the
    main path's 128 rows of 7995 / 10005 samples and 16 frames, or rows long
    enough for an n_fft whose half reaches past them (the reflection needs
    more than n_fft/2 samples, and 640 * (frames - 1) > n_fft/2 at the
    per-row hop); 8 rows past an n_fft of 8192, whose plain version's
    frames would take gigabytes (still more frames than the device-memory
    layout's grid has blocks)."""
    half = -(-n_fft // 2) + 1
    frames = max(16, -(-half // 640) + 1)
    return (128 if n_fft <= 8192 else 8, max(7995, n_fft),
            10005 if frames == 16 else 640 * frames + 5, frames)


def check_mel(torch, cuda_lib, melspec, cfg, name=None):
    """The mel kernel at ``cfg.n_fft`` and the main path's shapes: 128 rows
    of 7995 samples (static hop) and 128 rows of 10005 samples (per-row hop
    640, the 25 fps request; longer rows where the n_fft needs them,
    ``mel_rows``), fp32 and bf16 out, against the plain version; each call
    must launch it once. With ``name``, timed in turn with ``torch.stft`` +
    the mel matmul at the same config, and its kernels-line entry
    returned."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows_n, s_static, s_dyn, f_dyn = mel_rows(cfg.n_fft)
    wav = torch.randn(rows_n, s_static, device="cuda", generator=g) * 0.3
    wav_d = torch.randn(rows_n, s_dyn, device="cuda", generator=g) * 0.3
    hops = torch.full((rows_n,), 640, dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
    errs = {}
    plan = melspec.fft_plan(cfg)
    fpb, shared = melspec.block_layout(cfg.n_fft, cfg.hop_length)
    tag = f"mel n_fft {cfg.n_fft} (radices {plan.radices}, {fpb} frames " \
          f"a block, shared {shared})"
    for rows, (w_, kw) in {"static": (wav, {}),
                           "dynamic_hop": (wav_d, {"hop": hops,
                                                   "n_frames_out": f_dyn})
                           }.items():
        before = cuda_lib.launches["melspec"]
        got = melspec.log_mel_spectrogram(w_, cfg, **kw)
        got_bf = melspec.log_mel_spectrogram(w_, cfg, bf, **kw).float()
        require(cuda_lib.launches["melspec"] == before + 2,
                f"{tag} {rows}: {cuda_lib.launches['melspec'] - before} "
                f"melspec launches for two calls")
        errs[rows] = (got - melspec.log_mel_spectrogram_reference(w_, cfg, **kw)
                      ).abs().max().item()
        want = melspec.log_mel_spectrogram_reference(w_, cfg, bf, **kw).float()
        ok = bool(((got_bf - want).abs()
                   <= MEL_ATOL + ulp_bf16(torch, want)).all())
        errs[rows + "_bf16"] = (got_bf - want).abs().max().item()
        require(errs[rows] <= MEL_ATOL and ok,
                f"{tag} kernel vs plain: {errs} (tol {MEL_ATOL}, bf16 + one ulp)")
    if name is None:
        return {"n_fft": cfg.n_fft, "radices": list(plan.radices),
                "rows": rows_n, "frames_per_block": fpb, "shared": shared,
                "max_abs_err": errs}
    plain = timed(torch, lambda: melspec.log_mel_spectrogram_reference(wav, cfg, bf))
    win = torch.hann_window(cfg.win_length, periodic=True, device="cuda")
    fb = torch.from_numpy(melspec.mel_filterbank(cfg)).cuda()

    def library():
        spec = torch.stft(wav, cfg.n_fft, cfg.hop_length, window=win,
                          center=True, pad_mode="reflect", return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2               # [N, bins, F]
        return torch.log(power.transpose(1, 2) @ fb + cfg.log_eps).to(bf)
    t = timed_alternating(torch, {
        "kernel": lambda: melspec.log_mel_spectrogram(wav, cfg, bf),
        "library": library})
    (ms, ms_spread), (lib, lib_spread) = t["kernel"], t["library"]
    # The function's own work, whatever the algorithm: per frame the window,
    # a real FFT (5/2 n log2 n), the power of each bin, the mel product over
    # the filterbank's nonzero weights (each bin lies in at most two
    # triangles) and the log; bytes are the wav in and the log-mel out
    # (constants such as the filterbank are not inputs).
    frames = rows_n * melspec.num_frames(s_static, cfg)
    n, bins = cfg.n_fft, cfg.n_fft // 2 + 1
    nnz = int((plan.band_hi - plan.band_lo).sum())
    flops = frames * (n + 2.5 * n * math.log2(n) + 3 * bins + 2 * nnz
                      + cfg.n_mels)
    nbytes = wav.numel() * 4 + frames * cfg.n_mels * 2
    b_ms, b_by = bound(nbytes, flops, PEAK_FP32)
    emit({"phase": "kernel_" + name, "n_fft": n, "radices": list(plan.radices),
          "frames_per_block": fpb, "max_abs_err": errs,
          "tol": MEL_ATOL, "ms": ms, "ms_spread": ms_spread, "plain_ms": plain,
          "library_ms": lib, "library_ms_spread": lib_spread,
          "bound_ms": b_ms})
    return {"name": name, "max_abs_err": max(errs["static"], errs["dynamic_hop"]),
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib}


def check_mel_sizes(torch, cuda_lib, melspec, MelConfig):
    """The mel kernel untimed at MEL_CHECK_N_FFT and the largest n_fft its
    plan takes (one frame a block, its FFT buffers and tables in device
    memory); the next odd and even n_fft must be refused before any
    launch."""
    res = []
    for n in MEL_CHECK_N_FFT + (melspec.largest_n_fft(),):
        res.append(check_mel(torch, cuda_lib, melspec,
                             MelConfig(n_fft=n, win_length=n)))
    require({r["shared"] for r in res} == {True, False},
            f"mel sizes: not both layouts held: {res}")
    refusals = {}
    for too_large in (melspec.largest_n_fft() + 1, melspec.largest_n_fft() + 2):
        before = dict(cuda_lib.launches)
        try:
            melspec.log_mel_spectrogram(
                torch.zeros(1, too_large, device="cuda"),
                MelConfig(n_fft=too_large, win_length=too_large))
            refused = None
        except ValueError as e:
            refused = str(e)
        require(refused is not None and cuda_lib.launches == before,
                f"mel n_fft {too_large}: not refused before a launch")
        refusals[too_large] = refused
    emit({"phase": "kernel_mel_sizes", "checks": res, "tol": MEL_ATOL,
          "refusals": refusals})


def check_gru(torch, cuda_lib, gru):
    """K2 at the main path's shapes: B=16 sequences, T=128, H=256, both
    directions, bf16 x_proj and W_hh (gru.backend="xla"); fp32 too. The
    wrapper must take the cluster route ("gru" counts, "gru_stream" does
    not); the stream route (the first design, forced) is held the same way.
    Timed in turn: the kernel, the stream route, the port's layer (x @ W_ih
    + b_ih, then the kernel: what models/gru.py runs) and ``nn.GRU`` on the
    same input (it computes the layer); then the kernel at the train step's
    shape (B=8, T=64) with the fp32 carries kept, held (output and carries)
    and timed."""
    B, T, H, D = 16, 128, 256, 2
    g = torch.Generator(device="cuda").manual_seed(2)
    xp = torch.randn(B, T, D, 3 * H, device="cuda", generator=g)
    w = torch.randn(D, H, 3 * H, device="cuda", generator=g) / math.sqrt(H)
    b = torch.randn(D, 3 * H, device="cuda", generator=g) * 0.1
    bf = torch.bfloat16
    xb, wb = xp.to(bf), w.to(bf)
    errs = {}
    for route in ("cluster", "stream"):
        before = dict(cuda_lib.launches)
        errs[route + "_fp32"] = (gru._gru_forward(xp, w, b, route=route)
                                 - gru.gru_scan_reference(xp, w, b)
                                 ).abs().max().item()
        errs[route + "_bf16"] = (
            gru._gru_forward(xb, wb, b, route=route).float()
            - gru.gru_scan_reference(xb, wb, b).float()).abs().max().item()
        moved = {k: cuda_lib.launches[k] - before[k]
                 for k in ("gru", "gru_stream")}
        counter = "gru" if route == "cluster" else "gru_stream"
        require(moved == {**{"gru": 0, "gru_stream": 0}, counter: 2},
                f"gru {route} route launches {moved}")
    before = dict(cuda_lib.launches)
    gru.gru_scan(xb, wb, b)
    require(cuda_lib.launches["gru"] == before["gru"] + 1
            and cuda_lib.launches["gru_stream"] == before["gru_stream"],
            "gru_scan at the serving shape did not take the cluster route")
    for route in ("cluster", "stream"):
        require(errs[route + "_fp32"] <= GRU_ATOL_F32
                and errs[route + "_bf16"] <= GRU_ATOL_BF16,
                f"gru {route} kernel vs plain: {errs} (tol {GRU_ATOL_F32}, "
                f"{GRU_ATOL_BF16})")
    plain = timed(torch, lambda: gru.gru_scan_reference(xb, wb, b))
    ref = torch.nn.GRU(768, H, batch_first=True, bidirectional=True).cuda().to(bf)
    ref.flatten_parameters()
    x_in = torch.randn(B, T, 768, device="cuda", generator=g).to(bf)
    w_ih = (torch.randn(768, D * 3 * H, device="cuda", generator=g)
            / math.sqrt(768)).to(bf)
    b_ih = (torch.randn(D * 3 * H, device="cuda", generator=g) * 0.1).to(bf)
    with torch.no_grad():
        t = timed_alternating(torch, {
            "kernel": lambda: gru.gru_scan(xb, wb, b),
            "stream": lambda: gru._gru_forward(xb, wb, b, route="stream"),
            "layer": lambda: gru.gru_scan(
                (x_in @ w_ih + b_ih).reshape(B, T, D, 3 * H), wb, b),
            "library": lambda: ref(x_in)})
    (ms, ms_spread), (lib, lib_spread) = t["kernel"], t["library"]
    xt = xb[:8, :64].contiguous()
    got, want = (f(xt, wb, b, carries=True)
                 for f in (gru._gru_forward, gru.gru_scan_reference))
    errs["cluster_train_bf16"] = max(
        (got[0].float() - want[0].float()).abs().max().item(),
        (got[1] - want[1]).abs().max().item())
    require(errs["cluster_train_bf16"] <= GRU_ATOL_BF16,
            f"gru at the train shape, output and carries: {errs}")
    train_ms = timed(torch, lambda: gru._gru_forward(xt, wb, b, carries=True))
    carry = check_gru_carry(torch, cuda_lib, gru, xp, w, b)
    flops = 2 * D * T * B * H * 3 * H
    nbytes = xb.numel() * 2 + wb.numel() * 2 + b.numel() * 4 + B * T * D * H * 2
    b_ms, b_by = bound(nbytes, flops, PEAK_BF16)
    emit({"phase": "kernel_gru", "route": "cluster",
          "plan": gru.gru_plan(B, T, H, D, True)._asdict(),
          "max_abs_err": errs, "tol_bf16": GRU_ATOL_BF16,
          "tol_fp32": GRU_ATOL_F32, "ms": ms, "ms_spread": ms_spread,
          "stream_ms": t["stream"][0], "stream_ms_spread": t["stream"][1],
          "plain_ms": plain, "layer_ms": t["layer"][0],
          "layer_ms_spread": t["layer"][1],
          "library_ms_nn_gru_incl_input_proj": lib,
          "library_ms_spread": lib_spread, "train_ms_b8_t64_carries": train_ms,
          "bound_ms": b_ms, "carried_state": carry})
    entry = {"max_abs_err": errs["cluster_bf16"], "plain_ms": plain,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
    return [dict(entry, name="gru", ms=ms),
            dict(entry, name="gru_stream", ms=t["stream"][0],
                 max_abs_err=errs["stream_bf16"])]


def check_gru_carry(torch, cuda_lib, gru, xp, w, b, split=48):
    """The carried state at the serving shape, bf16 and fp32 (x and W in
    one dtype), on both routes: a nonzero fp32 h0 against the plain version
    (output and final carry); a zero h0 bit-equal to none; each lane as a
    one-direction launch (lane 1 read reversed) cut at step ``split`` into
    two launches, the second from the first's fp32 carry, bit-equal to one
    launch (output, carries, final carry), which is also held against the
    two-direction launch's lane (reported: the sequence-parallel BiGRU
    scans its lanes one direction at a time); each route's counter, and
    only it, moves once a launch."""
    B, T, D, h3 = xp.shape
    H = h3 // 3
    g = torch.Generator(device="cuda").manual_seed(27)
    h0 = torch.randn(B, D, H, device="cuda", generator=g) * 0.5
    zero = torch.zeros_like(h0)
    out = {}
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        x, wd = xp.to(dt), w.to(dt)
        tol = GRU_ATOL_BF16 if dt == torch.bfloat16 else GRU_ATOL_F32
        for route in ("cluster", "stream"):
            counter = "gru" if route == "cluster" else "gru_stream"
            before = dict(cuda_lib.launches)
            got, last = gru._gru_forward(x, wd, b, route=route, h0=h0,
                                         last=True)
            want, want_last = gru.gru_scan_reference(x, wd, b, h0=h0,
                                                     last=True)
            err = max((got.float() - want.float()).abs().max().item(),
                      (last - want_last).abs().max().item())
            none = gru._gru_forward(x, wd, b, route=route)
            zeros = gru._gru_forward(x, wd, b, route=route, h0=zero)
            both = gru._gru_forward(x, wd, b, route=route, carries=True)
            split_equal, lane_equal = [], []
            for lane in range(D):
                xl = x[:, :, lane:lane + 1]
                xl = (xl.flip(1) if lane else xl).contiguous()
                wl, bl = wd[lane:lane + 1], b[lane:lane + 1]
                one = gru._gru_forward(xl, wl, bl, route=route, carries=True,
                                       last=True)
                a = gru._gru_forward(xl[:, :split].contiguous(), wl, bl,
                                     route=route, carries=True, last=True)
                c = gru._gru_forward(xl[:, split:].contiguous(), wl, bl,
                                     route=route, carries=True, h0=a[2],
                                     last=True)
                split_equal.append(
                    torch.equal(torch.cat([a[0], c[0]], 1), one[0])
                    and torch.equal(torch.cat([a[1], c[1]], 1), one[1])
                    and torch.equal(c[2], one[2]))
                ref = both[1][:, :, lane:lane + 1]
                lane_equal.append(torch.equal(one[1],
                                              ref.flip(1) if lane else ref))
            moved = {k: cuda_lib.launches[k] - before[k]
                     for k in ("gru", "gru_stream")}
            launches = 4 + 3 * D
            key = f"{route}_{dname}"
            out[key] = {"h0_max_abs_err": err, "tol": tol,
                        "zero_h0_bit_equal": torch.equal(none, zeros),
                        "split_at": split,
                        "split_bit_equal_per_lane": split_equal,
                        "one_direction_lane_bit_equal_to_two": lane_equal,
                        "launches": moved}
            require(err <= tol and out[key]["zero_h0_bit_equal"]
                    and all(split_equal)
                    and moved == {"gru": 0, "gru_stream": 0,
                                  counter: launches},
                    f"gru carried state, {key}: {out[key]}")
    return out


# (B, T, H, D, x dtype, W dtype, tolerance): a batch tile half full with H
# not a multiple of 32, a second tile of one row, one direction, the pallas
# backend's fp32 W with bf16 x, and fp32 W at H=512, which fits no cluster
# (the stream route)
GRU_EDGE_SHAPES = ((5, 9, 72, 2, "float32", "float32", GRU_ATOL_F32),
                   (17, 3, 64, 2, "float32", "float32", GRU_ATOL_F32),
                   (5, 9, 72, 1, "bfloat16", "bfloat16", GRU_ATOL_BF16),
                   (16, 32, 256, 2, "bfloat16", "float32", GRU_ATOL_BF16),
                   (3, 5, 512, 2, "float32", "float32", GRU_ATOL_F32))


def sum_limits(y, y0, s20):
    """Per output channel, how far the conv unit's sums may lie from the
    plain version's: the channel's sum of |y - y0| (of |y^2 - y0^2|), i.e.
    the one-ulp differences of y that are held per element, plus CONV_S_REL
    of sum|y0| (of s20) for the fp32 summation order."""
    dims = tuple(range(y.dim() - 1))
    yf, y0f = y.float(), y0.float()
    lim1 = (yf - y0f).abs().sum(dims) + CONV_S_REL * y0f.abs().sum(dims) + 1e-6
    lim2 = (yf * yf - y0f * y0f).abs().sum(dims) + CONV_S_REL * s20 + 1e-6
    return lim1, lim2


def sums_within(s1, s2, s10, s20, lims):
    return bool(((s1 - s10).abs() <= lims[0]).all()
                and ((s2 - s20).abs() <= lims[1]).all())


def check_sums(what, y, y0, s1, s2, s10, s20, last):
    """Holds the sums per channel, then shows that the same check refuses a
    kernel whose s1 is zero, lies one channel off, or leaves out the share
    of y the kernel computes in its last partial step or strip (``last``
    from ``last_partial``: (name, s1 share); no such control when it is
    None). Returns the worst |s1 - s10| / limit."""
    lims = sum_limits(y, y0, s20)
    require(sums_within(s1, s2, s10, s20, lims),
            f"{what}: channel sums off by s1 {(s1 - s10).abs().max().item()}, "
            f"s2 {(s2 - s20).abs().max().item()}")
    wrong = {"s1_zero": s1 * 0, "s1_one_channel_off": s1.roll(1)}
    if last is not None:
        wrong[f"s1_{last[0]}_left_out"] = s1 - last[1]
    passed = [k for k, v in wrong.items() if sums_within(v, s2, s10, s20, lims)]
    require(not passed, f"{what}: the sums check would pass a wrong s1: {passed}")
    return ((s1 - s10).abs() / lims[0]).max().item()


def _round8(n):
    """The kernels' channel count: the wrappers zero-pad to multiples of 8."""
    return -(-n // 8) * 8


def last_partial(torch, conv_bn, kind, y, ci):
    """(name, s1 share) of the y pixels that the forward kernel computes in
    its last partial step: the spatial row walk's last step of the last
    range, the temporal frame walk's last strip of (clip, position) pairs
    (at every frame); None where that step or strip is full."""
    b, t, h, w, co = y.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kind == "temporal":
        plan = conv_bn.temporal_fwd_plan(b, t, h, w, _round8(ci), _round8(co),
                                         sms)
        rem = plan.positions % plan.strip
        if not rem:
            return None
        pairs = y.reshape(b, t, h * w, co).permute(0, 2, 1, 3).reshape(-1, t, co)
        return "last_partial_strip", pairs[-rem:].float().sum((0, 1))
    plan = conv_bn.spatial_fwd_plan(b, t, h, w, _round8(ci), _round8(co), sms)
    tail = len(plan.images_of(plan.ranges - 1)) * h * w % plan.step
    if not tail:
        return None
    return "last_partial_step", y.reshape(-1, co)[-tail:].float().sum(0)


def y_within(y, y0):
    """y per element: one bf16 ulp (CONV_Y_REL) plus a floor."""
    y0a = y0.float().abs()
    return bool(((y.float() - y0.float()).abs()
                 <= CONV_Y_REL * y0a + CONV_Y_ABS * y0a.max()).all())


def check_fwd_unit(torch, F, conv_bn, what, x, w, a, kind):
    """One forward unit: y per element and the sums per channel against the
    plain version, with their controls, and a second call must give the
    same bits. For the spatial kind the y check is shown to refuse a y whose
    zero padding went through the prologue (with the prologue) and a y from
    the filter with dh and dw swapped (images of more than one pixel); for
    the temporal kind a y whose zero frames at the clip edges went through
    the prologue (relu(shift), with the prologue), a y from the filter with
    taps 0 and 2 swapped (clips of more than one frame) and a y whose clips
    read their neighbours' frames across the boundary (more than one clip).
    Returns (max |dy|, worst sums error over its limit)."""
    y, s1, s2 = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
    y0, s10, s20 = conv_bn.conv_unit_reference(x, w, *a, kind=kind)
    err = (y.float() - y0.float()).abs().max().item()
    require(y_within(y, y0), f"{what}: max |dy| {err}")
    ratio = check_sums(what, y, y0, s1, s2, s10, s20,
                       last_partial(torch, conv_bn, kind, y, x.shape[-1]))
    wrong = {}
    kern = conv_bn._torch_kernel(w.to(x.dtype), kind)[0].contiguous(
        memory_format=torch.channels_last_3d)
    if kind == "spatial":
        if x.shape[2] * x.shape[3] > 1:       # 1x1 images read the centre tap only
            wrong["filter_dh_dw_swapped"] = conv_bn.conv_unit_reference(
                x, w.transpose(0, 1), *a, kind=kind)[0]
        pad = (0, 0, 1, 1, 1, 1)              # H and W: zero before the prologue
    else:
        if x.shape[1] > 1:                    # one frame reads the centre tap only
            wrong["filter_taps_0_2_swapped"] = conv_bn.conv_unit_reference(
                x, w.flip(0), *a, kind=kind)[0]
        if x.shape[0] > 1:                    # the clips as one long clip
            wrong["frames_leak_across_clips"] = conv_bn.conv_unit_reference(
                x.reshape(1, -1, *x.shape[2:]), w, *a, kind=kind)[0].reshape(
                    y0.shape)
        pad = (0, 0, 0, 0, 0, 0, 1, 1)        # T: zero frames before the prologue
    if a[0] is not None:
        xh = conv_bn._prologue(F.pad(x, pad), *a)
        key = "padding_through_prologue" if kind == "spatial" \
            else "edge_frames_through_prologue"
        wrong[key] = F.conv3d(xh.permute(0, 4, 1, 2, 3), kern
                              ).permute(0, 2, 3, 4, 1)
        del xh
    passed = [k for k, v in wrong.items() if y_within(v, y0)]
    require(not passed, f"{what}: the y check would pass: {passed}")
    del wrong
    y2, s12, s22 = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
    require(torch.equal(y2, y) and torch.equal(s12, s1) and torch.equal(s22, s2),
            f"{what}: a second call gave another y, s1 or s2")
    del y2
    return err, ratio


def _conv_units():
    """(kind, x shape, w shape, affine, copies per forward) of every fused
    unit of the full-width forward over 128 clips: 5 fused blocks (two in
    stage 1), each conv1 (spatial, no prologue; temporal) and conv2
    (spatial and temporal, both with the BN prologue)."""
    units = []
    for c, t, s, n in ((64, 16, 56, 2), (128, 8, 28, 1), (256, 4, 14, 1),
                       (512, 2, 7, 1)):
        mid = (27 * c * c) // (9 * c + 3 * c)
        units += [("spatial", (128, t, s, s, c), (3, 3, c, mid), False, n),
                  ("spatial", (128, t, s, s, c), (3, 3, c, mid), True, n),
                  ("temporal", (128, t, s, s, mid), (3, mid, c), True, 2 * n)]
    return units


def check_conv(torch, F, conv_bn):
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for kind, xs, ws, affine, copies in _conv_units():
        x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
        k = math.prod(ws[:-1])
        w = (torch.rand(*ws, device="cuda", generator=g) * 2 - 1) / math.sqrt(k)
        a = (None, None)
        if affine:
            a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
                 torch.randn(xs[-1], device="cuda", generator=g) * 0.1)
        what = f"conv unit {kind} {xs} affine={affine}"
        err, s1_ratio = check_fwd_unit(torch, F, conv_bn, what, x, w, a, kind)
        plain = timed(torch, lambda: conv_bn.conv_unit_reference(x, w, *a, kind=kind))
        xhat = torch.clamp_min(x * a[0].to(x.dtype) + a[1].to(x.dtype), 0) \
            if affine else x
        kern, pad = conv_bn._torch_kernel(w.to(x.dtype), kind)
        kern = kern.contiguous(memory_format=torch.channels_last_3d)

        def library():
            yl = F.conv3d(xhat.permute(0, 4, 1, 2, 3), kern, padding=pad)
            yf = yl.float()
            return yf.sum((0, 2, 3, 4)), (yf * yf).sum((0, 2, 3, 4))
        t = timed_alternating(torch, {
            "kernel": lambda: conv_bn.conv_unit_fwd(x, w, *a, kind=kind),
            "library": library})
        (ms, ms_spread), (lib, lib_spread) = t["kernel"], t["library"]
        m = math.prod(xs[:-1])
        flops = 2 * conv_bn.tap_pairs(kind, *xs[:4]) * xs[-1] * ws[-1]
        nbytes = x.numel() * 2 + w.numel() * 2 + m * ws[-1] * 2 \
            + (2 * xs[-1] * 4 if affine else 0) + 2 * ws[-1] * 4
        b_ms, _ = bound(nbytes, flops, PEAK_BF16)
        emit({"phase": "kernel_conv_unit", "kind": kind, "x": list(xs),
              "w": list(ws), "affine": affine, "per_forward": copies,
              "max_abs_err": err, "s1_err_over_limit": s1_ratio,
              "ms": ms, "ms_spread": ms_spread, "plain_ms": plain,
              "library_ms_conv3d_sums": lib, "library_ms_spread": lib_spread,
              "bound_ms": b_ms, "tflops": flops / ms / 1e9})
        acc = out.setdefault(kind, {"name": f"conv_unit_{kind}", "max_abs_err": 0.0,
                                    "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                    "library_ms": 0.0, "_ops": 0.0, "_bytes": 0.0})
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("_ops", flops / PEAK_BF16 * 1e3), ("_bytes", nbytes / HBM * 1e3)):
            acc[key] += copies * v
        del x, xhat
        torch.cuda.empty_cache()
    for acc in out.values():
        t_ops, t_bytes = acc.pop("_ops"), acc.pop("_bytes")
        acc["bound_ms"] = max(t_ops, t_bytes)
        acc["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return [out["spatial"], out["temporal"]]


def _train_units(clips):
    """(kind, x shape, w shape, affine, copies per train step) of the fused
    units of the full-width fusion train step over ``clips`` = B*W clips:
    per fused block conv1's spatial unit (no prologue) and temporal unit,
    conv2's spatial and temporal units (all three with the BN prologue)."""
    units = []
    for c, t, s, n in ((64, 16, 56, 2), (128, 8, 28, 1), (256, 4, 14, 1),
                       (512, 2, 7, 1)):
        mid = (27 * c * c) // (9 * c + 3 * c)
        units += [("spatial", (clips, t, s, s, c), (3, 3, c, mid), False, n),
                  ("spatial", (clips, t, s, s, c), (3, 3, c, mid), True, n),
                  ("temporal", (clips, t, s, s, mid), (3, mid, c), True, 2 * n)]
    return units


def ulp_bf16(torch, v):
    """One bf16 ulp at |v| (the spacing of bf16 values around it)."""
    a = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _abs_filter(torch, conv_bn, xh, ge, kind):
    """sum over pixels of |x^| * |ge| per filter element, fp32 (the scale
    of the filter gradient's summation error)."""
    ci, co = xh.shape[-1], ge.shape[-1]
    ksize = (1, 3, 3) if kind == "spatial" else (3, 1, 1)
    pad = (0, 1, 1) if kind == "spatial" else (1, 0, 0)
    dk = torch.nn.grad.conv3d_weight(
        xh.abs().float().permute(0, 4, 1, 2, 3), (co, ci) + ksize,
        ge.abs().float().permute(0, 4, 1, 2, 3), padding=pad)
    if kind == "spatial":
        return dk[:, :, 0].permute(2, 3, 1, 0)
    return dk[:, :, :, 0, 0].permute(2, 1, 0)


def bwd_within(torch, got, ref, lim):
    """Every check of one backward unit: dx per element, dw per element,
    dinv / dshift per channel (``lim`` from bwd_limits)."""
    dx, dw, dinv, dshift = got
    ok = bool(((dx.float() - ref[0].float()).abs() <= lim["dx"]).all())
    ok = ok and bool(((dw - ref[1]).abs() <= lim["dw"]).all())
    if dinv is not None:
        ok = ok and bool(((dinv - ref[2]).abs() <= lim["dinv"]).all())
        ok = ok and bool(((dshift - ref[3]).abs() <= lim["dshift"]).all())
    return ok


def bwd_limits(torch, conv_bn, x, inv, shift, y, gy, gs1, gs2, ref, dxa,
               dxa_ref, kind):
    """Per-element and per-channel limits of one backward unit (see the
    BWD_* tolerances). ``dxa`` / ``dxa_ref`` are the masked dx^ of the
    kernel and the plain version (the data gradient before the scale by
    inv; equal to dx without the prologue)."""
    dx0 = ref[0].float()
    lim = {"dx": ulp_bf16(torch, dx0) + BWD_DX_ABS * dx0.abs().max()}
    if inv is not None:
        lim["dx"] = lim["dx"] + ulp_bf16(torch, dx0) \
            + inv.to(x.dtype).float().abs() * ulp_bf16(torch, dxa_ref)
    xh = conv_bn._prologue(x, inv, shift)
    ge = conv_bn._gy_eff(gy, y, gs1, gs2)
    dwa = _abs_filter(torch, conv_bn, xh, ge, kind)
    lim["dw"] = BWD_DW_REL * dwa + BWD_DW_ABS * dwa.max()
    if inv is not None:
        dims = tuple(range(x.dim() - 1))
        xf, da, dr = x.float(), dxa.float(), dxa_ref.float()
        lim["dinv"] = (xf.abs() * (da - dr).abs()).sum(dims) \
            + BWD_S_REL * (xf * dr).abs().sum(dims) + 1e-6
        lim["dshift"] = (da - dr).abs().sum(dims) + BWD_S_REL * dr.abs().sum(dims) \
            + 1e-6
    return lim


def last_slice_left_out(torch, conv_bn, x, inv, shift, y, gy, gs1, gs2, dw,
                        kind):
    """The filter gradient ``dw`` without the share of the kernel's last
    slice, computed by the plain version on ge masked to that slice's units:
    the (b, t) images of ``spatial_filter_plan(...).units_of(slices - 1)``,
    or the clips x strips of ``temporal_filter_plan(...)``'s."""
    b, t, h, w, ci = x.shape
    co = gy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "spatial":
        plan = conv_bn.spatial_filter_plan(b, t, h, w, _round8(ci), _round8(co),
                                           sms)
        mask = torch.zeros(b * t, device=x.device)
        last = plan.units_of(plan.slices - 1)
        mask[last.start:last.stop] = 1
        mask = mask.reshape(b, t, 1, 1, 1)
    else:
        plan = conv_bn.temporal_filter_plan(b, t, h, w, _round8(ci),
                                            _round8(co), sms)
        strips = -(-h * w // plan.strip)
        mask = torch.zeros(b, h * w, device=x.device)
        for u in plan.units_of(plan.slices - 1):
            p0 = (u % strips) * plan.strip
            mask[u // strips, p0:p0 + plan.strip] = 1
        mask = mask.reshape(b, 1, h, w, 1)
    ge = (conv_bn._gy_eff(gy, y, gs1, gs2).float() * mask).to(gy.dtype)
    zero = torch.zeros(co, device=x.device)
    share = conv_bn.conv_unit_bwd_filter_reference(
        x, inv, shift, torch.zeros_like(y), ge, zero, zero, kind=kind)
    return dw - share


def check_bwd_unit(torch, conv_bn, what, x, w, inv, shift, gy, gs1, gs2,
                   kind):
    """One backward unit: kernel (data + filter) vs the plain version, held
    per element (dx, dw) and per channel (dinv, dshift); then shows that the
    same checks refuse a zeroed dinv, a dw one output channel off, a dw with
    taps 0 and 2 swapped (along dt or dh and, for the spatial kind, along dw;
    where the reference's differ), a dx whose walk's last step is left out
    (the spatial row walk's last step of pixels, the temporal frame walk's
    last unit), a dx from the filter with taps 0 and 2 swapped (along dt;
    for the spatial kind along h, and along w; each where it differs from
    the reference by more than the limit), and a dw without its last
    slice's partial; both gradients must give the same bits (dx, dinv,
    dshift, dw) on a second call.
    Returns the kernel's outputs, the reference and the worst error of each."""
    y, _, _ = conv_bn.conv_unit_fwd(x, w, inv, shift, kind=kind)
    dx, dinv, dshift = conv_bn.conv_unit_bwd_data(
        x, w, inv, shift, y, gy, gs1, gs2, kind=kind)
    dw = conv_bn.conv_unit_bwd_filter(x, inv, shift, y, gy, gs1, gs2, kind=kind)
    ref = conv_bn.conv_unit_bwd_reference(x, w, inv, shift, y, gy, gs1, gs2,
                                          kind=kind)
    if inv is not None:
        # the masked dx^ before the scale by inv, recovered from the mask
        mask = (x * inv.to(x.dtype) + shift.to(x.dtype)) > 0
        dxa_ref = conv_bn.conv_unit_bwd_data_reference(
            x, w, None, None, y, gy, gs1, gs2, kind=kind)[0] * mask
        dxa = conv_bn.conv_unit_bwd_data(x, w, None, None, y, gy, gs1, gs2,
                                         kind=kind)[0] * mask
    else:
        dxa, dxa_ref = dx, ref[0]
    lim = bwd_limits(torch, conv_bn, x, inv, shift, y, gy, gs1, gs2, ref, dxa,
                     dxa_ref, kind)
    got = (dx, dw, dinv, dshift)
    errs = {"dx": (dx.float() - ref[0].float()).abs().max().item(),
            "dw": (dw - ref[1]).abs().max().item()}
    if dinv is not None:
        errs["dinv_over_limit"] = ((dinv - ref[2]).abs() / lim["dinv"]).max().item()
        errs["dshift_over_limit"] = ((dshift - ref[3]).abs() / lim["dshift"]).max().item()
    errs["dw_over_limit"] = ((dw - ref[1]).abs() / lim["dw"]).max().item()
    errs["dx_over_limit"] = ((dx.float() - ref[0].float()).abs()
                             / lim["dx"]).max().item()
    require(bwd_within(torch, got, ref, lim), f"{what}: backward off: {errs}")
    wrong = {"dw_one_channel_off": (dx, dw.roll(1, dims=-1), dinv, dshift)}
    if bool(((ref[1].flip(0) - ref[1]).abs() > lim["dw"]).any()):
        wrong["dw_taps_0_2_swapped"] = (dx, dw.flip(0), dinv, dshift)
    if kind == "spatial" \
            and bool(((ref[1].flip(1) - ref[1]).abs() > lim["dw"]).any()):
        wrong["dw_taps_0_2_swapped_along_w"] = (dx, dw.flip(1), dinv, dshift)
    again = conv_bn.conv_unit_bwd_filter(x, inv, shift, y, gy, gs1, gs2,
                                         kind=kind)
    require(torch.equal(again, dw), f"{what}: a second call gave another dw")
    wrong["dw_last_slice_left_out"] = (dx, last_slice_left_out(
        torch, conv_bn, x, inv, shift, y, gy, gs1, gs2, dw, kind), dinv, dshift)
    if dinv is not None:
        wrong["dinv_zero"] = (dx, dw, dinv * 0, dshift)
    b, t, h, wd, ci = x.shape
    ci8, co8 = _round8(ci), _round8(gy.shape[-1])   # the kernel's widths
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "spatial":
        # the row walk's last step: the last pixels of the last range, up to
        # one step of them
        plan = conv_bn.spatial_data_plan(b, t, h, wd, ci8, co8, sms)
        q = len(plan.images_of(plan.ranges - 1)) * h * wd
        cut = dx.clone().reshape(-1, ci)
        cut[-(q - (q - 1) // plan.step * plan.step):] = 0
    else:
        # the frame walk's last unit: the last clip's last strip, every frame
        strip = conv_bn.temporal_data_plan(b, t, h, wd, ci8, co8, sms).strip
        cut = dx.clone().reshape(b, t, h * wd, ci)
        cut[-1, :, (h * wd - 1) // strip * strip:] = 0
    wrong["dx_last_tile_left_out"] = (cut.reshape(dx.shape), dw, dinv, dshift)
    swaps = {"dx_taps_0_2_swapped": (0,)} if kind == "temporal" else {
        "dx_taps_0_2_swapped_along_h": (0,), "dx_taps_0_2_swapped_along_w": (1,)}
    for name, dims in swaps.items():
        swapped = conv_bn.conv_unit_bwd_data_reference(
            x, w.flip(dims), inv, shift, y, gy, gs1, gs2, kind=kind)[0]
        if bool(((swapped.float() - ref[0].float()).abs() > lim["dx"]).any()):
            wrong[name] = (swapped, dw, dinv, dshift)
    dx2, dinv2, dshift2 = conv_bn.conv_unit_bwd_data(
        x, w, inv, shift, y, gy, gs1, gs2, kind=kind)
    require(torch.equal(dx2, dx) and (dinv is None or (
        torch.equal(dinv2, dinv) and torch.equal(dshift2, dshift))),
        f"{what}: a second call gave another dx, dinv or dshift")
    passed = [k for k, v in wrong.items() if bwd_within(torch, v, ref, lim)]
    require(not passed, f"{what}: the backward checks would pass: {passed}")
    return y, errs


def check_bwd(torch, F, conv_bn, clips=32):
    """The four backward kernels at the fusion train step's shapes: each
    held against its plain version, timed beside the plain version and
    cuDNN's backward (torch.nn.grad.conv3d_input / conv3d_weight, bf16).
    The forward units are timed at the same shapes too, for their share of
    the step, and the temporal one is held against its plain version there
    as at the serving shapes (phase ``conv_fwd_train_step``)."""
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    fwd_step = {"spatial": 0.0, "temporal": 0.0}
    fwd_errs = {}
    for kind, xs, ws, affine, copies in _train_units(clips):
        x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
        k = math.prod(ws[:-1])
        w = ((torch.rand(*ws, device="cuda", generator=g) * 2 - 1)
             / math.sqrt(k)).to(torch.bfloat16)
        a = (None, None)
        if affine:
            a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
                 torch.randn(xs[-1], device="cuda", generator=g) * 0.1)
        co = ws[-1]
        gy = (torch.randn(*xs[:-1], co, device="cuda", generator=g) * 1e-2
              ).to(torch.bfloat16)
        gs1 = torch.randn(co, device="cuda", generator=g) * 1e-5
        gs2 = torch.randn(co, device="cuda", generator=g) * 1e-6
        what = f"conv unit bwd {kind} {xs} affine={affine}"
        if kind == "temporal":
            fwd_errs[str(list(xs))] = check_fwd_unit(
                torch, F, conv_bn, f"conv unit {kind} {xs} (train)", x, w, a,
                kind)
        y, errs = check_bwd_unit(torch, conv_bn, what, x, w, *a, gy, gs1, gs2,
                                 kind)
        fwd_step[kind] += copies * timed(
            torch, lambda: conv_bn.conv_unit_fwd(x, w, *a, kind=kind))
        xh = conv_bn._prologue(x, *a)
        ge = conv_bn._gy_eff(gy, y, gs1, gs2)
        kern, pad = conv_bn._torch_kernel(w, kind)
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        xn, gn = xh.permute(0, 4, 1, 2, 3), ge.permute(0, 4, 1, 2, 3)
        xshape = (xs[0], xs[-1]) + tuple(xs[1:4])
        times = {
            "data": (timed(torch, lambda: conv_bn.conv_unit_bwd_data(
                        x, w, *a, y, gy, gs1, gs2, kind=kind)),
                     timed(torch, lambda: conv_bn.conv_unit_bwd_data_reference(
                         x, w, *a, y, gy, gs1, gs2, kind=kind)),
                     timed(torch, lambda: torch.nn.grad.conv3d_input(
                         xshape, kern, gn, padding=pad))),
            "filter": (timed(torch, lambda: conv_bn.conv_unit_bwd_filter(
                          x, *a, y, gy, gs1, gs2, kind=kind)),
                       timed(torch, lambda: conv_bn.conv_unit_bwd_filter_reference(
                           x, *a, y, gy, gs1, gs2, kind=kind)),
                       timed(torch, lambda: torch.nn.grad.conv3d_weight(
                           xn, kern.shape, gn, padding=pad)))}
        m, n_co, n_ci = math.prod(xs[:-1]), co, xs[-1]
        flops = 2 * conv_bn.tap_pairs(kind, *xs[:4]) * n_ci * n_co
        vec = 2 * n_co * 4 + (2 * n_ci * 4 if affine else 0)
        nbytes = {"data": 2 * m * n_co * 2 + w.numel() * 2 + m * n_ci * 2
                  + (m * n_ci * 2 if affine else 0) + vec + (2 * n_ci * 4 if affine else 0),
                  "filter": m * n_ci * 2 + 2 * m * n_co * 2 + vec
                  + w.numel() * 4}
        for part in ("data", "filter"):
            ms, plain, lib = times[part]
            emit({"phase": f"kernel_conv_bwd_{part}", "kind": kind, "x": list(xs),
                  "w": list(ws), "affine": affine, "per_step": copies,
                  "errors": errs, "ms": ms, "plain_ms": plain,
                  "library_ms": lib, "tflops": flops / ms / 1e9,
                  "bound_ms": bound(nbytes[part], flops, PEAK_BF16)[0]})
            name = f"conv_{kind}_bwd_{part}"
            acc = out.setdefault(name, {"name": name, "max_abs_err": 0.0,
                                        "ms": 0.0, "plain_ms": 0.0,
                                        "library_ms": 0.0, "_ops": 0.0,
                                        "_bytes": 0.0})
            e = errs["dx"] if part == "data" else errs["dw"]
            acc["max_abs_err"] = max(acc["max_abs_err"], e)
            for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                           ("_ops", flops / PEAK_BF16 * 1e3),
                           ("_bytes", nbytes[part] / HBM * 1e3)):
                acc[key] += copies * v
        del x, y, gy, xh, ge, xn, gn
        torch.cuda.empty_cache()
    for acc in out.values():
        t_ops, t_bytes = acc.pop("_ops"), acc.pop("_bytes")
        acc["bound_ms"] = max(t_ops, t_bytes)
        acc["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    emit({"phase": "conv_fwd_train_step", "clips": clips,
          "ms_per_step": fwd_step,
          "temporal_max_abs_err_and_s1_err_over_limit": fwd_errs})
    return [out[k] for k in BWD_KERNELS]


BWD_KERNELS = ("conv_spatial_bwd_data", "conv_spatial_bwd_filter",
               "conv_temporal_bwd_data", "conv_temporal_bwd_filter")


# Spatial shapes for the two row walks' tilings. The filter gradient: steps
# of 112 pixels, k-steps of 16, channel tiles of 64 x 48 and 32 x 48. The
# data gradient (spatial_data_plan): steps of 256 pixels x 64 input
# channels, or of 128 where a 256-pixel step's rows outgrow shared memory or
# a thread's copies; K in chunks of 16 output channels, the filter streamed
# chunk by chunk at every shape (it has no resident branch). W = 9 and 7
# (steps that span rows and images: a walk that leaks across images fails
# them), H = 1, W = 1 (a step of 256 over 301 rows), 1x1 images (steps of
# 128: a 256-pixel step's 513 rows outgrow shared memory), C_in 40 and 152
# (not a multiple of the channel block: a partial N tile), C_out 24 and 40
# (a last chunk half masked), a single image, a whole tensor (12 pixels)
# smaller than one step, 600 images of 15 pixels (two images per slice;
# five a data-gradient range, so one step spans five images), and images of
# 70 x 11 (seven steps a slice, whose 72 rows wrap the ring of 45). Then
# C_out 296, 288, 704, 512, 1024 and 440 (18 to 64 chunks a step; C_in 152
# with three N tiles, the last 24 wide; 1x1 images at C_out 440), and rows
# of 200 pixels (data gradient: steps of 128, a 256-pixel step's six rows
# outgrow a thread's copies); widths that are not multiples of 8, C_in 108 ->
# C_out 48 and 12 -> 20, which the wrappers zero-pad (both kinds). Temporal
# shapes for the two frame walks' tilings (the filter gradient's 64-position
# strips, channel blocks of 48 / 64, 64 output channels; the data gradient's
# strips of 64 / 32 / 16 positions x 144 input channels, its filter resident
# or streamed): clips of 1, 2 and 3 frames (a walk that leaks across clips
# fails them), C_in 40 and 152 (not a multiple of the channel block; 152 is
# two N tiles of the data gradient, the second 8 wide), C_out 24 and 40
# (padded to the k16 step), an H*W of 100 (a partial strip), and a whole
# tensor (40 positions) smaller than one strip: all with the data gradient's
# filter resident beside 64-position tiles, two frames ahead. Then, by the
# data gradient's planner: C_out 96, T = 3, 72 positions
# (resident, 64 positions, one frame ahead; C_in 8); C_out 104, T = 1, C_in
# 160 (resident, 32 positions, two frames ahead, two N tiles); C_out 144,
# C_in 296, 35 positions (resident, 32 positions, one frame ahead, three N
# tiles, a partial strip); C_out 160, T = 4 (streamed, 32 positions, three
# chunks a tap, the last 32 wide); C_out 344, T = 2, 9 positions (streamed,
# 16 positions, six chunks a tap, the last 24 wide and padded to 32).
BWD_EDGE_SHAPES = (("spatial", (3, 5, 7, 9, 24), (3, 3, 24, 40)),
                   ("spatial", (2, 3, 1, 11, 40), (3, 3, 40, 24)),
                   ("spatial", (2, 2, 6, 1, 24), (3, 3, 24, 16)),
                   ("spatial", (3, 4, 1, 1, 16), (3, 3, 16, 8)),
                   ("spatial", (2, 3, 5, 7, 152), (3, 3, 152, 40)),
                   ("spatial", (1, 1, 9, 13, 48), (3, 3, 48, 40)),
                   ("spatial", (1, 2, 2, 3, 16), (3, 3, 16, 24)),
                   ("spatial", (3, 200, 3, 5, 16), (3, 3, 16, 8)),
                   ("spatial", (1, 2, 70, 11, 24), (3, 3, 24, 40)),
                   ("spatial", (2, 3, 4, 3, 40), (3, 3, 40, 296)),
                   ("spatial", (1, 2, 9, 11, 40), (3, 3, 40, 288)),
                   ("spatial", (1, 2, 9, 9, 152), (3, 3, 152, 704)),
                   ("spatial", (1, 2, 14, 14, 40), (3, 3, 40, 512)),
                   ("spatial", (2, 3, 1, 1, 24), (3, 3, 24, 440)),
                   ("spatial", (1, 2, 7, 7, 24), (3, 3, 24, 1024)),
                   ("spatial", (1, 2, 3, 200, 24), (3, 3, 24, 40)),
                   ("spatial", (1, 2, 6, 6, 108), (3, 3, 108, 48)),
                   ("spatial", (2, 3, 4, 5, 12), (3, 3, 12, 20)),
                   ("temporal", (1, 2, 6, 6, 108), (3, 108, 48)),
                   ("temporal", (2, 3, 4, 5, 12), (3, 12, 20)),
                   ("temporal", (2, 7, 5, 3, 40), (3, 40, 24)),
                   ("temporal", (3, 1, 6, 5, 24), (3, 24, 16)),
                   ("temporal", (2, 2, 9, 9, 48), (3, 48, 40)),
                   ("temporal", (4, 3, 5, 7, 64), (3, 64, 24)),
                   ("temporal", (2, 4, 6, 6, 40), (3, 40, 24)),
                   ("temporal", (2, 3, 10, 10, 152), (3, 152, 40)),
                   ("temporal", (1, 2, 4, 5, 16), (3, 16, 8)),
                   ("temporal", (1, 3, 9, 8, 8), (3, 8, 96)),
                   ("temporal", (3, 1, 6, 5, 160), (3, 160, 104)),
                   ("temporal", (2, 3, 7, 5, 296), (3, 296, 144)),
                   ("temporal", (2, 4, 5, 5, 40), (3, 40, 160)),
                   ("temporal", (2, 2, 3, 3, 24), (3, 24, 344)))


def check_bwd_edges(torch, conv_bn):
    """The backward kernels at shapes off the tiling (BWD_EDGE_SHAPES): a
    partial row tile, masked channels, images smaller than a tile, short
    clips, partial strips, with and without the prologue. The prologue's
    shift lies away from zero (|shift| >= 0.2, either sign), so a border
    formed as relu(shift) instead of zero fails."""
    g = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for kind, xs, ws in BWD_EDGE_SHAPES:
        for affine in (False, True):
            x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
            w = (torch.randn(*ws, device="cuda", generator=g) * 0.1).to(torch.bfloat16)
            sh = torch.randn(xs[-1], device="cuda", generator=g) * 0.1
            a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
                 sh + 0.2 * torch.sign(sh)) if affine else (None, None)
            co = ws[-1]
            gy = torch.randn(*xs[:-1], co, device="cuda", generator=g).to(torch.bfloat16)
            gs1 = torch.randn(co, device="cuda", generator=g) * 0.1
            gs2 = torch.randn(co, device="cuda", generator=g) * 0.01
            _, errs[f"{kind}_{'x'.join(map(str, xs))}_affine={affine}"] = check_bwd_unit(
                torch, conv_bn, f"conv unit bwd {kind} at edge shape {xs} "
                f"affine={affine}", x, w, *a, gy, gs1, gs2, kind)
    emit({"phase": "kernel_bwd_edge_shapes", "errors": errs})


PROBE_KERNELS = ("packed_conv", "ablate_slabs", "ablate_matmul",
                 "packed_conv_chunked")


def _probe_inputs(torch, shape, seed):
    """x_cm random at every position (the margins and the tail too: the
    kernels read them as given), w_cm / sqrt(K), p_const; bf16 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(shape.BT, shape.CIN, shape.HWM, device="cuda", generator=g).to(bf)
    w = (torch.randn(shape.COUT, shape.K, device="cuda", generator=g)
         / math.sqrt(shape.K)).to(bf)
    p = torch.randn(shape.K, shape.HWP, device="cuda", generator=g).to(bf)
    return x, w, p


def _unmasked_im2col(torch, pc, x_cm, shape):
    """im2col without the x-edge masks (the negative control's P)."""
    return torch.cat([x_cm[:, :, shape.MARGIN + dy * shape.W + dx:][:, :, :shape.HWP]
                      for dy, dx in pc.TAPS], dim=1)


def probe_within(torch, got, want, lim):
    """Per element within ``lim``; bit for bit when ``lim`` is None."""
    if lim is None:
        return torch.equal(got.view(torch.int16), want.view(torch.int16))
    return bool(((got.float() - want.float()).abs() <= lim).all())


def check_probe_shape(torch, F, pc, shape, seed, timing):
    """The four probe kernels at ``shape`` against their plain versions on
    the same inputs: packed_conv with fp32 and bf16 y, packed_conv_chunked,
    ablate_slabs, ablate_matmul; each check is shown to refuse a y whose
    tail columns are zeroed and a y without the x-edge masks (the product
    ablation has no masks: a y whose last image is left out). With
    ``timing``, each kernel is timed beside its plain version and the
    library call. Returns {kernel: result}."""
    x, w, p = _probe_inputs(torch, shape, seed)
    y32 = pc.packed_conv_reference(x, w, shape, out_f32=True)
    lim32 = PROBE_F32_REL * torch.matmul(w.float().abs(),
                                         pc.im2col(x, shape).float().abs()) + PROBE_ABS
    lim16 = ulp_bf16(torch, y32) + lim32
    pu = _unmasked_im2col(torch, pc, x, shape)
    yu32 = torch.matmul(w.float(), pu.float())
    mm32 = torch.matmul(w.float(), p.float())
    lim_mm = ulp_bf16(torch, mm32) + PROBE_F32_REL * torch.matmul(
        w.float().abs(), p.float().abs()) + PROBE_ABS
    bf = torch.bfloat16
    # name: (kernel, plain version, limit, y without the masks or None)
    cases = {
        "packed_conv_f32": (lambda: pc.packed_conv(x, w, shape, out_f32=True),
                            lambda: pc.packed_conv_reference(x, w, shape, True),
                            lim32, yu32),
        "packed_conv": (lambda: pc.packed_conv(x, w, shape),
                        lambda: pc.packed_conv_reference(x, w, shape),
                        lim16, yu32.to(bf)),
        "packed_conv_chunked": (lambda: pc.packed_conv_chunked(x, w, shape),
                                lambda: pc.packed_conv_reference(x, w, shape),
                                lim16, yu32.to(bf)),
        "ablate_slabs": (lambda: pc.ablate_slabs(x, w, shape),
                         lambda: pc.ablate_slabs_reference(x, w, shape),
                         None, pu[:, :shape.COUT].contiguous()),
        "ablate_matmul": (lambda: pc.ablate_matmul(p, w, shape),
                          lambda: pc.ablate_matmul_reference(p, w, shape),
                          lim_mm, None)}
    del pu
    out = {}
    for name, (kern, plain, lim, unmasked) in cases.items():
        got, want = kern(), plain()
        what = f"{name} at {shape}"
        err = (got.float() - want.float()).abs().max().item()
        require(probe_within(torch, got, want, lim), f"{what}: max |dy| {err}")
        tail = got.clone()
        tail[:, :, shape.HW:] = 0
        wrong = {"tail_zeroed": tail}
        if unmasked is not None:
            wrong["no_x_edge_mask"] = unmasked
        else:
            last = got.clone()
            last[-1] = 0
            wrong["last_image_left_out"] = last
        passed = [k for k, v in wrong.items() if probe_within(torch, v, want, lim)]
        require(shape.HWP > shape.HW and not passed,
                f"{what}: the check would pass a wrong y: {passed}")
        res = {"max_abs_err": err,
               "err_over_limit": 0.0 if lim is None else
               ((got.float() - want.float()).abs() / lim).max().item()}
        if timing:
            res["ms"] = timed(torch, kern)
            res["plain_ms"] = timed(torch, plain)
        out[name] = res
        del got, want, tail, wrong
    if timing:
        hw = shape.MARGIN, shape.MARGIN + shape.HW
        x_nd = x[:, :, hw[0]:hw[1]].reshape(shape.BT, shape.CIN, shape.H, shape.W) \
            .contiguous(memory_format=torch.channels_last)
        w_nd = w.reshape(shape.COUT, 3, 3, shape.CIN).permute(0, 3, 1, 2) \
            .contiguous(memory_format=torch.channels_last)
        conv = timed(torch, lambda: F.conv2d(x_nd, w_nd, padding=1))
        p_bt = p.expand(shape.BT, -1, -1)
        # no single call gives the fp32 y or the slab copy
        lib = {"packed_conv_f32": None, "packed_conv": conv,
               "packed_conv_chunked": conv, "ablate_slabs": None,
               "ablate_matmul": timed(torch, lambda: torch.matmul(w, p_bt))}
        flops = 2 * shape.BT * shape.HWP * shape.K * shape.COUT
        x_b, w_b, p_b = x.numel() * 2, w.numel() * 2, p.numel() * 2
        y_b = shape.BT * shape.COUT * shape.HWP * 2
        # each input read once, y written once; the slab ablation reads only
        # x (w is not needed for its y)
        work = {"packed_conv_f32": (x_b + w_b + 2 * y_b, flops),
                "packed_conv": (x_b + w_b + y_b, flops),
                "packed_conv_chunked": (x_b + w_b + y_b, flops),
                "ablate_slabs": (x_b + y_b, 0),
                "ablate_matmul": (p_b + w_b + y_b, flops)}
        for name, res in out.items():
            res["bound_ms"], res["bound_by"] = bound(*work[name], PEAK_BF16)
            res["library_ms"] = lib[name]
            res["tflops"] = flops / res["ms"] / 1e9
    del x, w, p, y32, lim32, lim16, yu32, mm32, lim_mm
    torch.cuda.empty_cache()
    return out


def _probe_plans(pc, shape):
    """The conv walk's layout at ``shape`` for each conv kernel, and each
    ablation kernel's (``ablation_plan``)."""
    plans = {mode: {k: getattr(plan, k) for k in ("bn", "np", "stages",
                                                  "smem", "grid", "units")}
             for mode in pc.CONV_MODES for plan in [pc.packed_plan(shape, mode)]}
    plans.update({name: {k: getattr(plan, k) for k in (
        "bn", "np", "imgs", "yt", "windows", "stages", "resident", "smem", "grid",
        "items")}
        for name in pc.ABLATIONS for plan in [pc.ablation_plan(shape, name)]})
    return plans


def check_probe_odd_offset(torch, pc):
    """The four probe kernels on an input one element off 16 bytes (x_cm,
    or p_const for ablate_matmul; the wrappers copy it to aligned storage
    for the copy engine) held against their plain versions on the same
    values, each check shown to refuse the y of the storage's aligned
    start, the inputs shifted by one element. Returns {kernel: max |dy|}."""
    shape = pc.ProbeShape(B=2, T=3, H=20, W=20, CIN=16, COUT=24, CHUNK=128)
    x, w, p = _probe_inputs(torch, shape, 13)
    errs = {}
    for name in PROBE_KERNELS:
        a = p if name == "ablate_matmul" else x
        flat = torch.empty(a.numel() + 1, device="cuda", dtype=a.dtype)
        odd = flat[1:].view(a.shape)
        odd.copy_(a)
        require(odd.data_ptr() % 16 != 0, f"{name}: the view is on 16 bytes")
        kern = getattr(pc, name)
        got, shifted = kern(odd, w, shape), kern(flat[:-1].view(a.shape), w, shape)
        want = (pc.ablate_matmul_reference(odd, w, shape) if name == "ablate_matmul"
                else pc.ablate_slabs_reference(odd, w, shape)
                if name == "ablate_slabs" else pc.packed_conv_reference(odd, w, shape))
        if name == "ablate_slabs":
            lim = None
        else:
            pm = odd if name == "ablate_matmul" else pc.im2col(odd, shape)
            y32 = torch.matmul(w.float(), pm.float())
            lim = ulp_bf16(torch, y32) + PROBE_F32_REL * torch.matmul(
                w.float().abs(), pm.float().abs()) + PROBE_ABS
        err = (got.float() - want.float()).abs().max().item()
        require(probe_within(torch, got, want, lim),
                f"{name} on an input at an odd offset: max |dy| {err}")
        require(not probe_within(torch, shifted, want, lim),
                f"{name}: the odd-offset check would pass the inputs shifted "
                f"by one element")
        errs[name] = err
    return errs


def check_probe(torch, F, cuda_lib, pc, probe):
    """The probe slice: the four kernels held against their plain versions
    at the full shape (COUT 144, timed; COUT 128), at two shapes off the
    tiling and at COUT 264 over a partial last wave; the four on an input
    at an odd offset; then the probe itself (``probe.run``, every phase, at
    the full shape) with the counters set to 0 just before and read just
    after, and its check at COUT 128. Returns the kernels' entries and the
    launches."""
    full = check_probe_shape(torch, F, pc, pc.ProbeShape(), 8, timing=True)
    for name, res in full.items():
        emit({"phase": "kernel_probe", "kernel": name, "cout": 144, **res})
    emit({"phase": "kernel_probe_plans", "cout": 144,
          "plans": _probe_plans(pc, pc.ProbeShape())})
    errs = {name: r["max_abs_err"] for name, r in full.items()}
    for cout_shape, seed in ((pc.ProbeShape(COUT=128), 9),
                             # a lane tail of 112, COUT 24 (one N pass of
                             # 32), W not a multiple of 8, four chunks
                             (pc.ProbeShape(B=2, T=3, H=20, W=20, CIN=16,
                                            COUT=24, CHUNK=128), 10),
                             # COUT 152 (one pass of N 192 on 64
                             # positions), CIN 24 (the window boxes read
                             # zeros past CIN), four tiles a chunk
                             (pc.ProbeShape(B=1, T=2, H=12, W=12, CIN=24,
                                            COUT=152, CHUNK=256), 11),
                             # COUT 264: two N passes; 140 units over 132
                             # blocks, the last wave partial
                             (pc.ProbeShape(B=5, T=7, H=20, W=20, CIN=32,
                                            COUT=264, CHUNK=128), 12)):
        res = check_probe_shape(torch, F, pc, cout_shape, seed, timing=False)
        emit({"phase": "kernel_probe_shape", "shape": str(cout_shape),
              "errors": res, "plans": _probe_plans(pc, cout_shape)})
        for name, r in res.items():
            errs[name] = max(errs[name], r["max_abs_err"])
    emit({"phase": "kernel_probe_odd_offset",
          "errors": check_probe_odd_offset(torch, pc)})
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = probe.run(pc.ProbeShape(), probe.PHASES, iters=PROBE_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    want_zero = {k: v for k, v in counts.items() if k not in PROBE_KERNELS and v}
    missing = [k for k in PROBE_KERNELS if counts[k] == 0]
    require(not missing and not want_zero,
            f"probe launches {counts}: missing {missing}, stray {want_zero}")
    check128 = probe.check(probe.make_inputs(pc.ProbeShape(COUT=128), "cuda")[0],
                           pc.ProbeShape(COUT=128))
    ref = {"cout144": run["check"], "cout128": check128}
    require(all(v < PROBE_REF_REL for c in ref.values() for v in c.values()),
            f"packed conv vs reference_conv: {ref}, limit {PROBE_REF_REL}")
    emit({"phase": "probe_packed_conv", "iters": PROBE_ITERS, "s": dt,
          "launches": {k: counts[k] for k in PROBE_KERNELS},
          "rel_err_vs_reference_conv": ref, "tol": PROBE_REF_REL,
          "rows": [{"name": n, "ms": t * 1e3, "tflops": fl / t / 1e12}
                   for n, t, fl in run["rows"]]})
    entries = []
    for name in PROBE_KERNELS:
        r = full[name]
        entries.append({"name": name, "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return entries, counts


# Forward shapes off the main path's tiling (x shape, w shape). The spatial
# row walk (spatial_fwd_plan): W = 9, C_in 24 (a chunk half masked), C_out 40
# (steps of 256 x 64 channels, masked), images of 63 pixels (smaller than a
# step); C_out 136 (one N tile of 144, 8 masked) over images of 35 pixels;
# one image of 400 pixels (larger than a step) with W = 20 not dividing the
# step, the filter resident; 16 images of 15 pixels a range (a step spans
# nine images); C_in 152 (ten chunks, the last half masked) and C_out 288
# (five N tiles of 64, the filter resident) with W = 13; C_in 200 (the filter
# streamed) and C_out 152 (three N tiles of 64, the last 24 wide); C_in 264
# and C_out 288 (two N tiles of 144, the filter streamed); rows of 200
# pixels (steps of 128: a 256-pixel step's rows outgrow a thread's copies);
# one-pixel images (513 buffer rows); eight N tiles of a stage-4-like unit.
# The temporal frame walk (temporal_fwd_plan: strips of 128 (clip,
# position) pairs x 64 output channels): T 7 over 30 pairs (the whole
# tensor under one strip, C_in 40, C_out 24); T 1 (no tap but the centre);
# T 2 over 162 pairs (a partial last strip, C_out 40); T 3 over clips of 35
# pairs (strips span clips, a partial last one); strips over clips of 33
# pairs at T 2; C_in 152 (two chunks of 80, the last half masked); C_in 8;
# C_in 296 (three chunks) with three N tiles, the last 16 wide; C_out 160
# and 344 (three and six N tiles); C_in 576 with the filter streamed. Both
# kinds at widths that are not multiples of 8 (C_in 108 -> C_out 48 and 12
# -> 20: the wrapper zero-pads them).
FWD_EDGE_SHAPES = (("spatial", (3, 5, 7, 9, 24), (3, 3, 24, 40)),
                   ("spatial", (2, 3, 5, 7, 32), (3, 3, 32, 136)),
                   ("spatial", (1, 2, 20, 20, 24), (3, 3, 24, 144)),
                   ("spatial", (8, 250, 3, 5, 24), (3, 3, 24, 40)),
                   ("spatial", (2, 2, 11, 13, 152), (3, 3, 152, 288)),
                   ("spatial", (1, 2, 9, 9, 200), (3, 3, 200, 152)),
                   ("spatial", (1, 2, 6, 6, 264), (3, 3, 264, 288)),
                   ("spatial", (1, 3, 3, 200, 16), (3, 3, 16, 40)),
                   ("spatial", (3, 4, 1, 1, 16), (3, 3, 16, 8)),
                   ("spatial", (1, 2, 7, 7, 24), (3, 3, 24, 1152)),
                   ("spatial", (1, 2, 6, 6, 108), (3, 3, 108, 48)),
                   ("spatial", (2, 3, 4, 5, 12), (3, 3, 12, 20)),
                   ("temporal", (2, 7, 5, 3, 40), (3, 40, 24)),
                   ("temporal", (3, 1, 6, 5, 24), (3, 24, 16)),
                   ("temporal", (2, 2, 9, 9, 48), (3, 48, 40)),
                   ("temporal", (4, 3, 5, 7, 64), (3, 64, 24)),
                   ("temporal", (5, 2, 3, 11, 32), (3, 32, 24)),
                   ("temporal", (2, 3, 10, 10, 152), (3, 152, 40)),
                   ("temporal", (1, 3, 9, 8, 8), (3, 8, 96)),
                   ("temporal", (2, 3, 7, 5, 296), (3, 296, 144)),
                   ("temporal", (2, 4, 5, 5, 40), (3, 40, 160)),
                   ("temporal", (2, 2, 3, 3, 24), (3, 24, 344)),
                   ("temporal", (3, 3, 7, 7, 576), (3, 576, 256)),
                   ("temporal", (1, 2, 6, 6, 108), (3, 108, 48)),
                   ("temporal", (2, 3, 4, 5, 12), (3, 12, 20)))


def check_edges(torch, F, cuda_lib, melspec, gru, conv_bn, cfg):
    """Shapes off the main path's tiling, for the kernels' masked edges:
    the conv units at FWD_EDGE_SHAPES with and without the prologue (its
    shift away from zero, |shift| >= 0.2 either sign, so a border formed as
    relu(shift) fails), the GRU at GRU_EDGE_SHAPES, each on the route its
    planner gives it (its counter, and only it, moves), and mel rows whose
    last frame block is partial, for the static hop and for per-row hops."""
    g = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    for kind, xs, ws in FWD_EDGE_SHAPES:
        for affine in (False, True):
            x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
            w = torch.randn(*ws, device="cuda", generator=g) * 0.1
            sh = torch.randn(xs[-1], device="cuda", generator=g) * 0.1
            a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
                 sh + 0.2 * torch.sign(sh)) if affine else (None, None)
            key = f"conv_{kind}_{'x'.join(map(str, xs))}_affine={affine}"
            errs[key], errs[key + "_s1_err_over_limit"] = check_fwd_unit(
                torch, F, conv_bn, f"conv unit {kind} at edge shape {xs} "
                f"affine={affine}", x, w, a, kind)
    for B, T, H, D, xdt, wdt, tol in GRU_EDGE_SHAPES:
        xdt, wdt = getattr(torch, xdt), getattr(torch, wdt)
        xp = torch.randn(B, T, D, 3 * H, device="cuda", generator=g).to(xdt)
        w = (torch.randn(D, H, 3 * H, device="cuda", generator=g)
             / math.sqrt(H)).to(wdt)
        b = torch.randn(D, 3 * H, device="cuda", generator=g) * 0.1
        route = gru.gru_route(B, H, D, wdt == torch.bfloat16)
        counter = "gru" if route == "cluster" else "gru_stream"
        before = dict(cuda_lib.launches)
        key = f"gru_{B}x{T}x{H}_d{D}_{str(xdt)[6:]}_w_{str(wdt)[6:]}_{route}"
        errs[key] = (gru.gru_scan(xp, w, b).float()
                     - gru.gru_scan_reference(xp, w, b).float()
                     ).abs().max().item()
        moved = {k: cuda_lib.launches[k] - before[k]
                 for k in ("gru", "gru_stream")}
        require(moved == {**{"gru": 0, "gru_stream": 0}, counter: 1},
                f"gru at edge shape {key}: launches {moved}")
        require(errs[key] <= tol, f"gru at edge shape {key}: {errs[key]} "
                f"(tol {tol})")
    require(any(k.endswith("stream") for k in errs), "no gru edge shape "
            "took the stream route")
    # mel rows off the block tiling, one launch a call: 31 static frames at
    # n_fft 1024 and 401 (8 a block: a last block of 7; 401 odd, its rows a
    # whole number of hops long, so its last frame reaches one sample past
    # the padded row) and 4096 (4 a block: a last of 3); per-row hops of
    # 533, 640 and 667 over 13 frames (last blocks of 5 and 1), each row
    # reflecting about its own end; n_fft 401 over 3 static and 5 per-row
    # frames, fewer than a block; at 4096 per-row hops up to 3000, above
    # max_hop_length, which take a layout of fewer frames a block
    small_hops = [533, 640, 667]
    mel_edges = {}
    for n in (1024, 401, 4096):
        c = dataclasses.replace(cfg, n_fft=n, win_length=n)
        mel_edges[f"melspec_{n}"] = (c, 15990, None, None)
        mel_edges[f"melspec_{n}_dynamic_hop"] = (c, 12000, small_hops, 13)
    c401 = dataclasses.replace(cfg, n_fft=401, win_length=401)
    mel_edges["melspec_401_short"] = (c401, 1200, None, None)
    mel_edges["melspec_401_dynamic_hop_short"] = (c401, 3000, small_hops, 5)
    c4096 = dataclasses.replace(cfg, n_fft=4096, win_length=4096)
    mel_edges["melspec_4096_hop_above_max"] = (c4096, 36005, [533, 3000, 2500],
                                               13)
    require(melspec.block_layout(4096, 3000)
            != melspec.block_layout(4096, cfg.max_hop_length),
            "mel: a hop of 3000 takes the same layout at n_fft 4096")
    for key, (c, samples, hop_list, n_out) in mel_edges.items():
        w_ = torch.randn(3, samples, device="cuda", generator=g) * 0.3
        kw = {} if hop_list is None else {
            "hop": torch.tensor(hop_list, dtype=torch.int32, device="cuda"),
            "n_frames_out": n_out}
        before = cuda_lib.launches["melspec"]
        got = melspec.log_mel_spectrogram(w_, c, **kw)
        require(cuda_lib.launches["melspec"] == before + 1,
                f"mel at edge shape {key}: "
                f"{cuda_lib.launches['melspec'] - before} launches")
        errs[key] = (got - melspec.log_mel_spectrogram_reference(w_, c, **kw)
                     ).abs().max().item()
        require(errs[key] <= MEL_ATOL, f"mel at edge shape {key}: "
                f"{errs[key]} (tol {MEL_ATOL})")
    emit({"phase": "kernel_edge_shapes", "max_abs_err": errs})


def synthetic_video(np, n, fps, seed):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 112, 112, 3), dtype=np.uint8)
    wav = (rng.randn(int(round(n / fps * 16000)) + 16000) * 0.1).astype(np.float32)
    return frames, wav


FORWARD_KERNELS = ("melspec", "gru", "conv_spatial", "conv_temporal")


def serve(torch, np, cuda_lib, p, frames, wav, fps=None,
          kernels=FORWARD_KERNELS):
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = p.predict_video(frames=frames, waveform=wav, fps=fps)["pred"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    require(pred.shape == (len(frames), 2), f"pred shape {pred.shape}")
    require(bool(np.isfinite(pred).all()), "non-finite predictions")
    require(bool((np.abs(pred) <= 1.0).all()), "predictions outside [-1, 1]")
    missing = [k for k in kernels if counts[k] == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    return pred, counts, dt


def synthetic_stream(np, cfg, SyntheticAVDataset, WindowSequencer,
                     example_stream, seed):
    """The train stream over the seeded synthetic set (its data is made
    before the timed steps)."""
    ds = SyntheticAVDataset(cfg.data, cfg.model.mel, seed=seed)
    seq = WindowSequencer(cfg.window, cfg.model.mel, fps=cfg.data.fps,
                          mel_frames=cfg.model.audio.mel_frames_per_window)
    for vid in ds.video_ids():
        ds.load_video(vid)
    return lambda skip: example_stream(ds, seq, cfg.train.batch_size,
                                       seed=seed, skip_batches=skip)


def serve_many(torch, np, p, n_videos=3, pipeline=2):
    """``Predictor.predict_many`` over ``n_videos`` synthetic 1024-frame
    videos with ``pipeline`` in flight: the ids in input order, each
    prediction bit for bit ``predict_video``'s. The serial loop and the
    pipelined stream are timed in turn (serial, stream, stream, serial),
    host clock around each ending in a synchronise."""
    videos = [synthetic_video(np, 1024, 30.0, seed=10 + i) for i in range(n_videos)]
    times = {"serial": [], "pipelined": []}
    serial = many = None
    for run in ("serial", "pipelined", "pipelined", "serial"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "serial":
            serial = [p.predict_video(frames=f, waveform=w)["pred"]
                      for f, w in videos]
        else:
            many = list(p.predict_many(
                ((str(i), {"frames": f, "waveform": w})
                 for i, (f, w) in enumerate(videos)), pipeline=pipeline))
        torch.cuda.synchronize()
        times[run].append(time.perf_counter() - t0)
    require([vid for vid, _ in many] == [str(i) for i in range(n_videos)],
            f"predict_many order {[vid for vid, _ in many]}")
    require(all(np.array_equal(a, b) for (_, a), b in zip(many, serial)),
            "predict_many differs from predict_video")
    frames = 1024 * n_videos
    emit({"phase": "serve_many", "videos": n_videos, "frames_each": 1024,
          "pipeline": pipeline, "s": times["pipelined"],
          "serial_s": times["serial"],
          "frames_per_s": frames / min(times["pipelined"]),
          "serial_frames_per_s": frames / min(times["serial"])})


def _push_chunks(np, frames, wav, fps, seconds=1.0, sr=16000):
    """(frames, wav) chunks of ``seconds`` of a capture at ``fps``, then
    the audio's tail."""
    step = int(round(fps * seconds))
    for i in range(0, len(frames), step):
        a0, a1 = (int(round(f / fps * sr)) for f in (i, i + step))
        if i + step >= len(frames):
            a1 = len(wav)
        yield frames[i:i + step], wav[a0:a1]


def stream_within(np, got, want, what):
    """A stream's emission against offline predictions: the limits, and
    the numbers printed beside them."""
    require(got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}")
    d = np.abs(got - want)
    out = {"max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean()),
           "bit_equal_frames": float((d.max(axis=1) == 0).mean())}
    require(out["max_abs_diff"] <= STREAM_ATOL
            and out["mean_abs_diff"] <= STREAM_MEAN_ATOL,
            f"{what} vs predict_video: {out}")
    return out


def serve_stream(torch, np, cuda_lib, p, frames, wav, want, fps=None,
                 kernels=FORWARD_KERNELS, phase="serve_stream"):
    """One capture through ``p.stream(fps)``, a second of frames and audio
    a push, then flush; the counters set to 0 just before. The emission
    must cover every frame once, in order, and match ``predict_video``;
    each push is timed on the host clock ending in a synchronise."""
    cuda_lib.reset_launches()
    sess = p.stream(fps=fps)
    got, lat = [], []
    t0 = time.perf_counter()
    for f, w in _push_chunks(np, frames, wav, fps or 30.0):
        t = time.perf_counter()
        lo, pred = sess.push(frames=f, waveform=w)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        require(lo == sum(len(g) for g in got),
                f"{phase}: emission starts at {lo}, expected {sum(map(len, got))}")
        got.append(pred)
    lo, pred = sess.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(lo == sum(len(g) for g in got), f"{phase}: flush starts at {lo}")
    got.append(pred)
    counts = dict(cuda_lib.launches)
    missing = [k for k in kernels if counts[k] == 0]
    require(not missing, f"{phase}: kernels not launched: {missing}")
    result = {"phase": phase, "frames": len(frames), "fps": fps or 30.0,
              "pushes": len(lat), "latency_frames": sess.latency_frames,
              **stream_within(np, np.concatenate(got), want, phase),
              "tol_max": STREAM_ATOL, "tol_mean": STREAM_MEAN_ATOL,
              "push_p50_ms": float(np.percentile(lat, 50)) * 1e3,
              "push_p99_ms": float(np.percentile(lat, 99)) * 1e3,
              "s": dt, "frames_per_s": len(frames) / dt, "launches": counts}
    emit(result)
    return result


# 30 fps sessions of phase session_group starting at each tick (one push
# of 64 frames a tick, 4 pushes of a 256-frame video; a session readies one
# group at its 2nd, 3rd and 4th push): ticks then carry 1, 2, 4, 5, 9 and
# 4 groups, so the batches pad to every bucket 1, 2, 4, 8, 16. Beside them,
# from tick 0, one session at each off rate: their groups share batches
# of the dynamic-hop schema, each entry framed at its own mel hop
GROUP_STARTS = {0: 1, 4: 2, 8: 4, 12: 5, 14: 4}
GROUP_OFF_RATES = (25.0, 27.0)


def session_group(torch, np, cuda_lib, SessionGroup, p, n_frames=256,
                  kernels=FORWARD_KERNELS):
    """16 sessions on 16 seeded 30 fps videos fed tick by tick through
    ``push_many`` so that every batch bucket 1-16 occurs, beside one
    session at each of ``GROUP_OFF_RATES`` whose groups share batches at
    their own mel hops; each session's emission must match its own
    ``predict_video``. Returns the 30 fps videos and their offline
    predictions."""
    n = sum(GROUP_STARTS.values())
    fps = [30.0] * n + list(GROUP_OFF_RATES)
    videos = [synthetic_video(np, n_frames, r, seed=100 + i)
              for i, r in enumerate(fps)]
    offline = [p.predict_video(frames=f, waveform=w,
                               fps=None if r == 30.0 else r)["pred"]
               for (f, w), r in zip(videos, fps)]
    group = SessionGroup(p, max_batch=16)
    sizes, hops = [], []
    fwd = group._fwd

    def recording(feed):
        if "hop" in feed:
            hops.append(feed["hop"].tolist())
        else:
            sizes.append(len(feed["video"]))
        return fwd(feed)
    group._fwd = recording
    begin = [tick for tick, k in sorted(GROUP_STARTS.items())
             for _ in range(k)] + [0] * len(GROUP_OFF_RATES)
    sessions = [group.open(fps=None if r == 30.0 else r) for r in fps]
    chunks = [list(_push_chunks(np, f, w, r, seconds=64 / r))
              for (f, w), r in zip(videos, fps)]
    got = [[] for _ in sessions]
    ticks = []
    cuda_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tick in range(max(GROUP_STARTS) + 4):
        pushes = {}
        for i, s in enumerate(sessions):
            j = tick - begin[i]
            if 0 <= j < len(chunks[i]):
                pushes[s] = {"frames": chunks[i][j][0], "waveform": chunks[i][j][1]}
        t = time.perf_counter()
        outs = group.push_many(pushes)
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t)
        for i, s in enumerate(sessions):
            if s in outs:
                got[i].append(outs[s][1])
    for i, s in enumerate(sessions):
        got[i].append(group.flush(s)[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    missing = [k for k in kernels if counts[k] == 0]
    require(not missing, f"session_group: kernels not launched: {missing}")
    require({1, 2, 4, 8, 16} <= set(sizes), f"session_group batches {sizes}")
    require(any(len(set(h)) == len(GROUP_OFF_RATES) for h in hops),
            f"session_group: no batch held every off rate's hop: {hops}")
    diffs = [stream_within(np, np.concatenate(g), want, f"session {i}")
             for i, (g, want) in enumerate(zip(got, offline))]
    emit({"phase": "session_group", "sessions": n,
          "off_rate_sessions": list(GROUP_OFF_RATES), "frames_each": n_frames,
          "batches": sizes, "dynamic_hop_batches": hops, "ticks": len(ticks),
          "tick_ms": [t * 1e3 for t in ticks],
          "max_abs_diff": max(d["max_abs_diff"] for d in diffs),
          "mean_abs_diff": max(d["mean_abs_diff"] for d in diffs),
          "bit_equal_frames": min(d["bit_equal_frames"] for d in diffs),
          "tol_max": STREAM_ATOL, "tol_mean": STREAM_MEAN_ATOL,
          "s": dt, "frames_per_s": len(fps) * n_frames / dt, "launches": counts})
    return videos[:n], offline[:n]


def _http(url, body=None, headers=None, timeout=120):
    import urllib.request
    req = urllib.request.Request(url, data=body, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _npz(np, **arrays):
    import io
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def http_server(torch, np, PredictServer, p, frames, wav, want, videos, offline):
    """An in-process PredictServer on an OS-assigned port: /predict with an
    x-npy answer on the 1024-frame video, bit for bit ``predict_video``'s;
    then ``HTTP_STREAMS`` streams pushed at once from threads, each
    matching its own ``predict_video``; /statz's latency and batches."""
    import io
    import threading
    srv = PredictServer(p, port=0)
    thread = srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        body = _npz(np, frames=frames, waveform=wav)
        t0 = time.perf_counter()
        pred = np.load(io.BytesIO(_http(base + "/predict", body,
                                        {"Accept": "application/x-npy"})))
        predict_s = time.perf_counter() - t0
        require(np.array_equal(pred, want), "/predict differs from predict_video")
        results, errors = [None] * HTTP_STREAMS, []

        def run(i):
            try:
                sid = json.loads(_http(base + "/stream/open", b""))["id"]
                got = []
                for f, w in _push_chunks(np, *videos[i], 30.0):
                    out = json.loads(_http(f"{base}/stream/{sid}/push",
                                           _npz(np, frames=f, waveform=w)))
                    got.append(np.asarray(out["pred"], np.float32).reshape(-1, 2))
                out = json.loads(_http(f"{base}/stream/{sid}/flush", b""))
                got.append(np.asarray(out["pred"], np.float32).reshape(-1, 2))
                results[i] = np.concatenate(got)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"stream {i}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(HTTP_STREAMS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        streams_s = time.perf_counter() - t0
        require(not any(t.is_alive() for t in threads), "an HTTP stream hung")
        require(not errors, f"HTTP streams failed: {errors}")
        diffs = [stream_within(np, r, offline[i], f"HTTP stream {i}")
                 for i, r in enumerate(results)]
        statz = json.loads(_http(base + "/statz"))
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    emit({"phase": "http_server", "predict_frames": len(frames),
          "predict_bytes": len(body), "predict_s": predict_s,
          "streams": HTTP_STREAMS, "streams_s": streams_s,
          "max_abs_diff": max(d["max_abs_diff"] for d in diffs),
          "mean_abs_diff": max(d["mean_abs_diff"] for d in diffs),
          "tol_max": STREAM_ATOL, "tol_mean": STREAM_MEAN_ATOL,
          "latency": statz["latency"],
          "micro_batch_hist": statz["micro_batch_hist"],
          "bytes_in": statz["bytes_in"]})


TRACE_KERNELS = {"melspec": "log_mel_kernel", "gru": "gru_cluster_kernel",
                 "conv_spatial": "spatial_fwd_kernel",
                 "conv_temporal": "temporal_fwd_kernel"}


def device_ms_by_op(trace_dir, device_cats):
    """Device ms of the newest trace under ``trace_dir`` by the host op
    that launched each device event: the outermost op around its launch
    with that op's first input's shape, or, where no op was around it (the
    port's kernels, launched through ctypes), the kernel's name. Returns
    ({op: [ms, count]}, {(op, shape): [ms, count]})."""
    import glob
    import gzip
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                         recursive=True), key=os.path.getmtime)
    with gzip.open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    by_op, by_shape = {}, {}
    for e in events:
        if e.get("cat") not in device_cats or not e.get("dur"):
            continue
        r = launch.get(e.get("args", {}).get("correlation"))
        around = [o for o in ops if r is not None and o["tid"] == r["tid"]
                  and o["ts"] <= r["ts"] <= o["ts"] + o["dur"]]
        if around:
            o = max(around, key=lambda o: o["dur"])
            name = o["name"]
            dims = o.get("args", {}).get("Input Dims") or [[]]
            shape = str(dims[0])
        else:
            name, shape = e["name"][:60], ""
        for table, key in ((by_op, name), (by_shape, (name, shape))):
            row = table.setdefault(key, [0.0, 0])
            row[0] += e["dur"] / 1e3
            row[1] += 1
    return by_op, by_shape


def trace_serve(torch, np, profiling, p, frames, wav, trace_dir):
    """``profiling.trace`` around one ``predict_video`` of the 1024-frame
    video: the device time by op (top ``TRACE_TOP``) and in all beside the
    host time, and the time of the four kernels against the rest; every
    kernel of the path must be among the device events."""
    shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.synchronize()
    with profiling.trace(trace_dir):
        t0 = time.perf_counter()
        p.predict_video(frames=frames, waveform=wav)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    rows = profiling.summarize_trace(trace_dir, top=10 ** 6, group=False)
    device_ms = profiling.device_total_ms(trace_dir)
    names = [r["op"] for r in rows]
    missing = [k for k, kern in TRACE_KERNELS.items()
               if not any(kern in n for n in names)]
    require(not missing, f"trace_serve: no device event of {missing}")
    ours = sum(r["ms"] for r in rows
               if any(k in r["op"] for k in TRACE_KERNELS.values()))
    copies = sum(r["ms"] for r in rows if r["op"].startswith("Memcpy"))
    by_op, by_shape = device_ms_by_op(trace_dir, profiling.DEVICE_CATS)
    by_op = sorted(by_op.items(), key=lambda kv: -kv[1][0])
    by_shape = sorted(by_shape.items(), key=lambda kv: -kv[1][0])
    emit({"phase": "trace_serve", "frames": len(frames), "host_ms": host_s * 1e3,
          "device_ms": device_ms, "idle_share": 1 - device_ms / (host_s * 1e3),
          "kernels_ms": ours, "memcpy_ms": copies,
          "rest_ms": device_ms - ours - copies, "device_ops": len(rows),
          "top": [{"op": r["op"][:100], "ms": r["ms"],
                   "percent": r["percent"], "count": r["count"]}
                  for r in rows[:TRACE_TOP]],
          "by_launching_op": [{"op": k, "ms": v[0], "count": v[1]}
                              for k, v in by_op[:TRACE_TOP]],
          "by_launching_op_and_shape": [
              {"op": k[0], "input": k[1], "ms": v[0], "count": v[1]}
              for k, v in by_shape[:TRACE_TOP]]})


def _video_dict(np, frames, wav, seed):
    """A video for ``Trainer``'s eval: the frames and wav, labels in
    [-1, 1] from ``seed`` and a span of frames marked invalid."""
    rng = np.random.RandomState(seed)
    n = len(frames)
    valid = np.ones(n, bool)
    valid[n // 3:n // 3 + 40] = False
    return {"frames": frames, "waveform": wav, "valid": valid,
            "labels": rng.uniform(-1, 1, (n, 2)).astype(np.float32)}


def serve_ensemble(torch, np, cuda_lib, Trainer, cfg, frames, wav, counts1):
    """Two ensemble members, ``commit_state(..., eval_only=True)`` snapshots
    of the seed-0 and seed-1 inits of a ``Trainer`` of ``cfg``: the
    ensembles [a] and [a, a] repeat a's single prediction bit for bit, and
    [a, b] is bit for bit the float64 mean of the two single tracks, with
    exactly twice a served video's launches (``counts1``). Returns the
    trainer and the members."""
    tr = Trainer(cfg)
    a = tr.commit_state(tr.init_state(seed=0), eval_only=True)
    b = tr.commit_state(tr.init_state(seed=1), eval_only=True)
    video = _video_dict(np, frames, wav, seed=0)
    single_a = tr.evaluate_video(a, video)["pred"]
    single_b = tr.evaluate_video(b, video)["pred"]
    require(not np.array_equal(single_a, single_b),
            "the seed-0 and seed-1 members predict the same")
    for members in ([a], [a, a]):
        got = tr.predict_ensemble(members, video)
        require(np.array_equal(got, single_a),
                f"ensemble of {len(members)} x a differs from a by "
                f"{float(np.abs(got - single_a).max())}")
    mean = np.mean([single_a, single_b], axis=0, dtype=np.float64
                   ).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    ens = tr.predict_ensemble([a, b], video)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    want = {k: 2 * v for k, v in counts1.items()}
    require(counts == want, f"ensemble launches {counts}, expected {want}")
    require(ens.shape == (len(frames), 2) and bool(np.isfinite(ens).all()),
            f"ensemble prediction {ens.shape}")
    require(np.array_equal(ens, mean), "ensemble [a, b] is not the float64 "
            f"mean of a and b: {float(np.abs(ens - mean).max())}")
    emit({"phase": "serve_ensemble", "frames": len(frames), "members": 2,
          "launches": counts, "s": dt, "frames_per_s": len(frames) / dt,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "max_abs_a_minus_b": float(np.abs(single_a - single_b).max())})
    return tr, a, b


def eval_ensemble(torch, np, write_submission, tr, a, b, out_dir,
                  n_videos=3, n_frames=1024):
    """``evaluate_ensemble([a, b])`` over ``serve_many``'s synthetic videos
    (labels from seeds, a span invalid): ``n_models`` 2 and finite metrics;
    the mean tracks then go through ``write_submission`` into ``out_dir``:
    one file a video, each of ``n_frames + 1`` lines."""
    videos = {f"video_{i}": _video_dict(
        np, *synthetic_video(np, n_frames, 30.0, seed=10 + i), seed=20 + i)
        for i in range(n_videos)}

    class Split:
        def video_ids(self):
            return list(videos)

        def load_video(self, vid):
            return videos[vid]
    preds = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.evaluate_ensemble(
        [a, b], Split(), per_video_fn=lambda vid, r: preds.update({vid: r["pred"]}))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    keys = ("ccc_v", "ccc_a", "ccc_mean", "pooled_ccc_v", "pooled_ccc_a",
            "pooled_ccc_mean", "ccc_select")
    require(res["n_models"] == 2 and all(math.isfinite(res[k]) for k in keys),
            f"evaluate_ensemble: {res}")
    if os.path.isdir(out_dir):
        for f in os.listdir(out_dir):
            os.unlink(os.path.join(out_dir, f))
    write_submission(out_dir, preds,
                     {vid: v["valid"] for vid, v in videos.items()})
    files = sorted(os.listdir(out_dir))
    require(files == sorted(f"{vid}.txt" for vid in videos),
            f"submission files {files}")
    for f in files:
        with open(os.path.join(out_dir, f)) as fh:
            lines = fh.read().splitlines()
        require(len(lines) == n_frames + 1 and lines[0] == "valence,arousal",
                f"{f}: {len(lines)} lines, header {lines[:1]}")
    emit({"phase": "eval_ensemble", "videos": n_videos, "frames_each": n_frames,
          "members": 2, "s": dt, "frames_per_s": n_videos * n_frames / dt,
          "submission_files": len(files),
          **{k: res[k] for k in keys}})


def train_fusion_options(torch, np, cuda_lib, config, Trainer, data,
                         counts_train, plain, overrides=None, steps=10):
    """The full-width fusion preset with ``model.dropout=0.1`` and
    ``data.augment=true``: 2 warm steps, then two fits of ``steps`` from the
    seed. The first has the counters set to 0 just before; its launches
    must be ``train_fusion``'s (``counts_train``), its losses finite and
    different from ``train_fusion``'s (``plain``: its losses and step
    time); the second must repeat its losses bit for bit."""
    cfg = config.apply_overrides(config.fusion(), {
        "train.log_every": 1, "model.dropout": 0.1, "data.augment": True,
        **(overrides or {})})
    tr = Trainer(cfg)
    stream = synthetic_stream(np, cfg, *data, seed=0)
    tr.fit(stream, num_steps=2, log=lambda s: None)             # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    ends = []
    t0 = time.perf_counter()
    _, hist = tr.fit(stream, num_steps=steps,
                     log=lambda s: ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    step_s = (ends[-1] - ends[0]) / (steps - 1)
    require(counts == counts_train,
            f"train launches with the options {counts}, expected {counts_train}")
    loss = hist["loss"]
    require(len(loss) == steps and all(math.isfinite(v) for v in loss),
            f"train loss with the options {loss}")
    _, again = tr.fit(stream, num_steps=steps, log=lambda s: None)
    require(again["loss"] == loss,
            f"a second fit from the seed gave {again['loss']}, not {loss}")
    require(loss != plain["loss"],
            "the losses with dropout and augmentation are the plain fit's")
    clips = cfg.train.batch_size * cfg.window.windows_per_clip
    emit({"phase": "train_fusion_options", "dropout": cfg.model.dropout,
          "augment": cfg.data.augment, "steps": steps, "launches": counts,
          "s": dt, "s_per_step": step_s, "clips_per_s": clips / step_s,
          "plain_s_per_step": plain["s_per_step"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss": loss, "plain_loss": plain["loss"],
          "repeats_bit_for_bit": True})


def init_from(torch, config, Trainer, save_pytree, to_jax_params, path,
              overrides=None):
    """``model.init_from``: an ``r2plus1d``-kind file written from the
    seed-0 fusion model's ``visual.*``; a fusion ``Trainer`` seeded 1 with
    it set starts (step 0) with the file's ``visual.*`` and every other
    tensor of its own seed's init."""
    cfg0 = config.apply_overrides(config.fusion(), overrides or {})
    src = Trainer(cfg0).model
    leaves = {}
    for group, tensors in (("params", dict(src.named_parameters())),
                           ("state", dict(src.named_buffers()))):
        visual = {n[len("visual."):]: t for n, t in tensors.items()
                  if n.startswith("visual.")}
        leaves.update({f"{group}/{k}": v
                       for k, v in to_jax_params(visual).items()})
    save_pytree(leaves, path, {"kind": "r2plus1d"})
    want_visual = {n: t.detach().clone() for n, t in src.state_dict().items()
                   if n.startswith("visual.")}
    del src
    cfg1 = config.apply_overrides(cfg0, {"train.seed": 1})
    seeded = Trainer(cfg1).init_state()
    own = {n: t.detach().clone() for n, t in
           {**seeded.params, **seeded.bn_state}.items()}
    tr = Trainer(config.apply_overrides(cfg1, {"model.init_from": path}))
    state = tr.init_state()
    require(state.step == 0, f"init_from state at step {state.step}")
    tensors = {**state.params, **state.bn_state}
    require(tensors.keys() == own.keys(), "init_from changed the state's names")
    bad_v = [n for n in want_visual if not torch.equal(tensors[n], want_visual[n])]
    bad_o = [n for n in own if not n.startswith("visual.")
             and not torch.equal(tensors[n], own[n])]
    require(not bad_v, f"visual.* not the file's: {bad_v[:5]}")
    require(not bad_o, f"tensors outside visual.* not the seed's: {bad_o[:5]}")
    moved = sum(not torch.equal(want_visual[n], own[n]) for n in want_visual)
    require(moved > 0, "the file's visual.* equal the seed-1 init (no control)")
    emit({"phase": "init_from", "kind": "r2plus1d",
          "visual_tensors": len(want_visual), "other_tensors":
          len(own) - len(want_visual), "visual_differing_from_seed": moved})


def train_fusion(torch, np, cuda_lib, config, Trainer, data):
    """The full-width fusion preset trains on the card through Trainer.fit:
    2 warm steps, then a second fit of 10 steps whose launches must be
    exactly the kernels' per-step counts times 10. Every fit starts over
    from the seed; the step time is taken between the ends of its first and
    last step (each logged after a synchronising read of the loss), so the
    re-initialisation is reported beside it (``s``, the whole fit) and not
    in it."""
    cfg = config.apply_overrides(config.fusion(), {"train.log_every": 1})
    tr = Trainer(cfg)
    stream = synthetic_stream(np, cfg, *data, seed=0)
    tr.fit(stream, num_steps=2, log=lambda s: None)             # warm
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 10
    cuda_lib.reset_launches()
    ends = []
    t0 = time.perf_counter()
    _, hist = tr.fit(stream, num_steps=steps,
                     log=lambda s: ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_s = (ends[-1] - ends[0]) / (steps - 1)
    counts = dict(cuda_lib.launches)
    per_step = {"melspec": 1, "gru": cfg.model.gru.num_layers,
                "conv_spatial": 10, "conv_temporal": 10,
                "conv_spatial_bwd_data": 10, "conv_spatial_bwd_filter": 10,
                "conv_temporal_bwd_data": 10, "conv_temporal_bwd_filter": 10}
    want = {k: per_step.get(k, 0) * steps for k in cuda_lib.launches}
    require(counts == want, f"train launches {counts}, expected {want}")
    loss, gnorm = hist["loss"], hist["grad_norm"]
    require(len(loss) == steps and all(math.isfinite(v) for v in loss + gnorm),
            f"train loss {loss}, grad norm {gnorm}")
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in tr.model.named_parameters())
    require(moved > 0, "the params did not move")
    clips = cfg.train.batch_size * cfg.window.windows_per_clip
    emit({"phase": "train_fusion", "batch": cfg.train.batch_size,
          "windows": cfg.window.windows_per_clip, "steps": steps,
          "launches": counts, "s": dt, "s_per_step": step_s,
          "clips_per_s": clips / step_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss": loss, "grad_norm": gnorm, "max_param_move": moved})
    return counts, {"loss": loss, "s_per_step": step_s}


def perturbed(np, video):
    """A uint8 video as the model sees it (x / 255, fp32), each pixel one
    part in 1e7 off with a seeded random sign: a rounding-level change."""
    v = video.astype(np.float32) / np.float32(255)
    sign = np.random.RandomState(7).choice(np.float32([-1, 1]), v.shape)
    return v * (np.float32(1) + np.float32(1e-7) * sign)


def train_parity(torch, np, cuda_lib, config, Trainer, data):
    """One narrow model (a two-stage R(2+1)D whose stage-1 blocks run every
    fused unit, plus a strided block), the same weights and batches: 3 SGD
    steps with the plain versions on the CPU and with the kernels on the
    card, in bf16 and in fp32 (``card_fp32`` against ``cpu_fp32``, through
    rows 3f-8f); the CPU's own fp32 run is reported beside the bf16 pair,
    and beside the fp32 pair the CPU's fp32 run on a ``perturbed`` video
    (``cpu_fp32_perturbed``: the spread of a rounding-level change)."""
    overrides = {"model.visual.block_channels": [32, 64],
                 "model.visual.blocks_per_stage": [2, 1],
                 "model.visual.stem_channels": 32,
                 "model.visual.feature_dim": 64,
                 "model.audio.channels": [8, 16, 32, 64],
                 "model.audio.feature_dim": 64,
                 "model.gru.hidden_size": 64,
                 "window.windows_per_clip": 2, "train.batch_size": 2,
                 "train.log_every": 1, "train.optim.optimizer": "sgd",
                 "train.optim.learning_rate": 1e-2, "data.image_size": 32,
                 "data.synthetic_num_videos": 2,
                 "data.synthetic_video_frames": 64}
    runs = {}
    need = {"bfloat16": FORWARD_KERNELS + BWD_KERNELS,
            "float32": ("melspec", "gru", "conv_spatial_f32",
                        "conv_temporal_f32") + F32_BWD_KERNELS}
    for run, dev, dtype in (("cpu", "cpu", "bfloat16"),
                            ("cpu_fp32", "cpu", "float32"),
                            ("cpu_fp32_perturbed", "cpu", "float32"),
                            ("card", "cuda", "bfloat16"),
                            ("card_fp32", "cuda", "float32")):
        cfg = config.apply_overrides(config.fusion(), {
            **overrides, "model.compute_dtype": dtype})
        tr = Trainer(cfg, device=dev)
        if run != "cpu":
            tr.model.load_state_dict(runs["cpu"][2])
        init = {k: v.clone() for k, v in tr.model.state_dict().items()}
        w0 = torch.cat([p.detach().cpu().flatten() for p in tr.model.parameters()])
        stream = synthetic_stream(np, cfg, *data, seed=1)
        if run == "cpu_fp32_perturbed":
            stream = (lambda base: lambda skip: (
                dict(bt, video=perturbed(np, bt["video"])) for bt in base(skip)))(
                    stream)
        cuda_lib.reset_launches()
        _, hist = tr.fit(stream, num_steps=3, log=lambda s: None,
                         keep_weights=run != "cpu")
        if dev == "cuda":
            missing = [k for k in need[dtype] if cuda_lib.launches[k] == 0]
            require(not missing, f"narrow card training ({run}) skipped "
                    f"{missing}")
        w = torch.cat([p.detach().cpu().flatten() for p in tr.model.parameters()])
        runs[run] = (hist["loss"], w, init, w0)

    def gap(run, base):
        loss, w, _, w0 = runs[base]
        other = runs[run]
        return (max(abs(a - b) for a, b in zip(loss, other[0])),
                (other[1] - w).norm().item() / (w - w0).norm().item())
    loss = runs["cpu"][0]
    dloss, drel = gap("card", "cpu")
    ref_loss, ref_rel = gap("cpu_fp32", "cpu")
    f32_loss, f32_rel = gap("card_fp32", "cpu_fp32")
    pert_loss, pert_rel = gap("cpu_fp32_perturbed", "cpu_fp32")
    result = {"phase": "train_parity_cpu_vs_card", "steps": 3,
              "loss_cpu": loss, "loss_card": runs["card"][0],
              "max_abs_loss_diff": dloss, "tol_loss": TRAIN_LOSS_ATOL,
              "param_diff_over_move": drel, "tol_param": TRAIN_PARAM_REL,
              "cpu_bf16_vs_fp32": {"max_abs_loss_diff": ref_loss,
                                   "param_diff_over_move": ref_rel},
              "card_fp32_vs_cpu_fp32": {
                  "loss_cpu_fp32": runs["cpu_fp32"][0],
                  "loss_card_fp32": runs["card_fp32"][0],
                  "max_abs_loss_diff": f32_loss, "tol_loss": F32_TRAIN_LOSS_ATOL,
                  "param_diff_over_move": f32_rel,
                  "tol_param": F32_TRAIN_PARAM_REL},
              "cpu_fp32_perturbed_vs_cpu_fp32": {
                  "max_abs_loss_diff": pert_loss,
                  "param_diff_over_move": pert_rel}}
    require(dloss <= TRAIN_LOSS_ATOL and drel <= TRAIN_PARAM_REL,
            f"narrow training card vs CPU: {result}")
    require(f32_loss <= F32_TRAIN_LOSS_ATOL and f32_rel <= F32_TRAIN_PARAM_REL,
            f"narrow fp32 training card vs CPU: {result}")
    emit(result)


# ---------------------------------------------------------------------------
# fp32 conv units (rows 3f / 4f), the lane widths, and every visual backbone
# ---------------------------------------------------------------------------

def f32_limit(torch, F, conv_bn, x, w, a, kind):
    """The fp32 y check's limit per element: CONV_F32_REL of sum |x^|*|w|
    over the output's taps (x^ the plain prologue's), plus CONV_F32_ABS."""
    xh = conv_bn._prologue(x, *a) if a[0] is not None else x
    kern, pad = conv_bn._torch_kernel(w.float().abs(), kind)
    s = F.conv3d(xh.abs().permute(0, 4, 1, 2, 3),
                 kern.contiguous(memory_format=torch.channels_last_3d),
                 padding=pad).permute(0, 2, 3, 4, 1)
    return s.mul_(CONV_F32_REL).add_(CONV_F32_ABS)


def f32_within(y, y0, lim):
    return bool(((y - y0).abs() <= lim).all())


def spatial_plan_f32(torch, conv_bn, x, co):
    """The fp32 spatial row walk's plan for x [B, T, H, W, C_in] -> C_out
    (channel counts as the wrapper pads them), or None (the gather)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return conv_bn.f32_spatial_fwd_plan(*x.shape[:4], _round8(x.shape[-1]),
                                        _round8(co), sms)


def temporal_plan_f32(torch, conv_bn, x, co):
    """The fp32 temporal frame walk's plan for x [B, T, H, W, C_in] ->
    C_out (channel counts as the wrapper pads them)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return conv_bn.f32_temporal_fwd_plan(*x.shape[:4], _round8(x.shape[-1]),
                                         _round8(co), sms)


def last_range_f32(torch, conv_bn, kind, x, y):
    """(name, s1 share) of the y the fp32 forward computes in its last
    range: for the temporal frame walk the last range of strips (every
    frame of their positions), or its last partial strip where one range
    holds them all; for the spatial row walk the last range of images, or
    its last partial step; else the gather's last range of position tiles
    (None where nothing is left over)."""
    b, t, h, w, co = y.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if kind == "temporal":
        plan = temporal_plan_f32(torch, conv_bn, x, co)
        pos = y.reshape(b, t, h * w, co).permute(0, 2, 1, 3).reshape(-1, t, co)
        if plan.ranges > 1:
            start = plan.units_of(plan.ranges - 1)[0] * plan.strip
            return "last_range", pos[start:].sum((0, 1))
        tail = plan.positions % plan.strip
        return None if not tail else \
            ("last_partial_strip", pos[-tail:].sum((0, 1)))
    walk = spatial_plan_f32(torch, conv_bn, x, co) if kind == "spatial" \
        else None
    if walk is not None:
        if walk.ranges > 1:
            start = (walk.ranges - 1) * walk.images_per_range * h * w
            return "last_range", y.reshape(-1, co)[start:].sum(0)
        tail = walk.images * h * w % walk.step
        return None if not tail else \
            ("last_partial_step", y.reshape(-1, co)[-tail:].sum(0))
    plan = conv_bn.f32_fwd_plan(b, t, h, w, _round8(co), sms)
    if plan.ranges < 2:
        return None
    start = (plan.ranges - 1) * plan.tiles_per_range * 64
    return "last_range", y.reshape(-1, co)[start:].sum(0)


def f32_unit_inputs(torch, g, xs, ws, affine):
    """fp32 x, w and (inv, shift) for one unit. With the prologue, shift is
    -(x0 * inv) rounded once, and clip 0 holds x0 at every position: there
    x^ = relu((x0 * inv) + shift) is 0 exactly when the product and the
    sum round apart (the reference), and x0*inv - f32(x0*inv), half the
    time above 0, when one fused multiply-add rounds them together."""
    x = torch.randn(*xs, device="cuda", generator=g)
    k = math.prod(ws[:-1])
    w = (torch.rand(*ws, device="cuda", generator=g) * 2 - 1) / math.sqrt(k)
    if not affine:
        return x, w, (None, None)
    inv = torch.rand(xs[-1], device="cuda", generator=g) + 0.5
    x0 = torch.rand(xs[-1], device="cuda", generator=g) - 0.5
    x[0] = x0
    return x, w, (inv, -(x0 * inv))


def check_fwd_unit_f32(torch, F, conv_bn, what, x, w, a, kind):
    """One fp32 unit against its plain version: y per element within
    f32_limit, the sums per channel (sum_limits), each shown to refuse the
    wrong answers: a y from the filter with dh / dw (spatial) or taps 0 / 2
    (temporal) swapped, a y whose padding went through the prologue, a y
    whose prologue rounds once (a fused multiply-add), a y whose clips read
    their neighbours' frames (temporal, more than one clip), a zeroed or
    channel-shifted s1 and an s1 without the last range's share; a second
    call must give the same bits. Returns (max |dy|, worst |dy| / limit,
    worst sums error / limit)."""
    y, s1, s2 = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
    y0, s10, s20 = conv_bn.conv_unit_reference(x, w, *a, kind=kind)
    lim = f32_limit(torch, F, conv_bn, x, w, a, kind)
    d = (y - y0).abs()
    err, over = d.max().item(), (d / lim).max().item()
    del d
    require(over <= 1.0, f"{what}: |dy| over its limit by {over} (max {err})")
    ratio = check_sums(what, y, y0, s1, s2, s10, s20,
                       last_range_f32(torch, conv_bn, kind, x, y))
    wrong = {}
    if kind == "spatial" and x.shape[2] * x.shape[3] > 1:
        wrong["filter_dh_dw_swapped"] = lambda: conv_bn.conv_unit_reference(
            x, w.transpose(0, 1), *a, kind=kind)[0]
    if kind == "temporal" and x.shape[1] > 1:
        wrong["filter_taps_0_2_swapped"] = lambda: conv_bn.conv_unit_reference(
            x, w.flip(0), *a, kind=kind)[0]
    if kind == "temporal" and x.shape[0] > 1:     # the clips as one long clip
        wrong["frames_leak_across_clips"] = lambda: conv_bn.conv_unit_reference(
            x.reshape(1, -1, *x.shape[2:]), w, *a, kind=kind)[0].reshape(
                y0.shape)
    if a[0] is not None:
        pad = (0, 0, 1, 1, 1, 1) if kind == "spatial" else (0, 0, 0, 0, 0, 0, 1, 1)
        kern = conv_bn._torch_kernel(w, kind)[0].contiguous(
            memory_format=torch.channels_last_3d)
        wrong["padding_through_prologue"] = lambda: F.conv3d(
            conv_bn._prologue(F.pad(x, pad), *a).permute(0, 4, 1, 2, 3),
            kern).permute(0, 2, 3, 4, 1)
        wrong["fused_mul_add_prologue"] = lambda: conv_bn.conv_unit_reference(
            torch.clamp_min((x.double() * a[0].double() + a[1].double())
                            .float(), 0), w, kind=kind)[0]
    passed = [k for k, fn in wrong.items() if f32_within(fn(), y0, lim)]
    require(not passed, f"{what}: the y check would pass: {passed}")
    y2, s12, s22 = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)
    require(torch.equal(y2, y) and torch.equal(s12, s1) and torch.equal(s22, s2),
            f"{what}: a second call gave another y, s1 or s2")
    return err, over, ratio


# fp32 shapes off the serving tiling: M not a multiple of the 64-position
# tile, C_out 40 and 72 (a partial output-channel tile), C_in 24 and 40 (a
# partial 16-channel chunk), 1x1 images (every spatial tap but the centre in
# the padding), one frame and two (temporal padding), and widths that are
# not multiples of 8 (C_in 12 -> C_out 20, 108 -> 48: zero-padded by the
# wrapper); each with and without the prologue
F32_EDGE_SHAPES = (("spatial", (3, 5, 7, 9, 24), (3, 3, 24, 40)),
                   ("spatial", (2, 3, 1, 1, 8), (3, 3, 8, 72)),
                   ("spatial", (2, 2, 9, 9, 12), (3, 3, 12, 20)),
                   ("spatial", (2, 2, 5, 7, 108), (3, 3, 108, 48)),
                   ("temporal", (2, 1, 6, 6, 24), (3, 24, 40)),
                   ("temporal", (3, 2, 5, 7, 40), (3, 40, 72)),
                   ("temporal", (2, 4, 6, 6, 12), (3, 12, 20)),
                   ("temporal", (2, 5, 5, 5, 108), (3, 108, 48)))
# the fp32 row walk off the serving tiling (forward only): 7x7 images two a
# range and a step, the last range one image (135 of them); C_out 200 in
# two N tiles of 128, the last masked; 1152 in eight tiles of 144 at
# several images a step; 256 in two tiles of 128
F32_WALK_EDGE_SHAPES = (("spatial", (3, 45, 7, 7, 24), (3, 3, 24, 40)),
                        ("spatial", (2, 3, 7, 7, 40), (3, 3, 40, 200)),
                        ("spatial", (2, 16, 7, 7, 64), (3, 3, 64, 1152)),
                        ("spatial", (2, 4, 14, 14, 32), (3, 3, 32, 256)))
# the spatial kind where no row-walk layout fits (images 240 wide, as from
# data.image_size above 400): the forward's per-tap gather; two clips,
# since f32_unit_inputs' prologue makes clip 0's x^ zero. The filter
# gradient's walk fits images 240 wide; at 600 it takes its per-tap gather
# too
F32_GATHER_EDGE_SHAPES = (("spatial", (2, 2, 2, 240, 16), (3, 3, 16, 16)),
                          ("spatial", (2, 2, 2, 600, 16), (3, 3, 16, 16)))
# the fp32 spatial filter gradient's row walk off the train tiling: 131 7x7
# images two a slice on 132 SMs (C_in 24: two channel blocks, one of them
# partial), the last slice one image; C_out 200 in two N tiles of 128, the
# last masked; 1x1 images, several a step; the stage-4 train shape (32
# clips, 256 blocks in one slice)
F32_FILTER_WALK_EDGE_SHAPES = (
    ("spatial", (1, 131, 7, 7, 24), (3, 3, 24, 40)),
    ("spatial", (2, 3, 4, 7, 40), (3, 3, 40, 200)),
    ("spatial", (3, 4, 1, 1, 16), (3, 3, 16, 72)),
    ("spatial", (32, 2, 7, 7, 512), (3, 3, 512, 1152)))
# the fp32 spatial data gradient's row walk off the train tiling: 129 7x7
# images four a range on 132 SMs, the last range one image, C_in 200 in
# four N tiles of 64 (the last masked), C_out 40 (chunks of 16, 16 and 8);
# 1x1 images, 22 a step, in N tiles of 128 and 8-channel chunks split nine
# ways; the stage-3 and stage-4 train shapes (32 clips), K split four and
# eight ways
F32_DATA_WALK_EDGE_SHAPES = (
    ("spatial", (1, 129, 7, 7, 200), (3, 3, 200, 40)),
    ("spatial", (3, 100, 1, 1, 16), (3, 3, 16, 72)),
    ("spatial", (32, 4, 14, 14, 256), (3, 3, 256, 576)),
    ("spatial", (32, 2, 7, 7, 512), (3, 3, 512, 1152)))
# the fp32 temporal data gradient's frame walk in N tiles of 144 (strips of
# 56) off the train tiling: five 7x7 clips of three frames, 245 positions
# over five strips, the last partial; 81 7x7 clips at C_in 280, two N
# tiles, the second masked, 71 strips (the last partial) in 36 ranges of
# two, the last of one
F32_TEMPORAL_DATA_144_SHAPES = (
    ("temporal", (5, 3, 7, 7, 144), (3, 144, 40)),
    ("temporal", (81, 3, 7, 7, 280), (3, 280, 40)))
# the fp32 temporal data gradient's frame walk off the train tiling: clips
# of one frame at C_out 40 (chunks of 16, 16 and 8); five 7x7 clips of
# three frames across strips, the last strip partial, at C_in 200 (a masked
# N tile of 64) over two ranges; C_out 200, the filter streamed beside the
# x slots with the prologue and resident without; the stage-4 train shape
# (32 clips, the filter streamed, 7 ranges of two strips); the tiles of 144
F32_TEMPORAL_DATA_EDGE_SHAPES = (
    ("temporal", (3, 1, 7, 7, 24), (3, 24, 40)),
    ("temporal", (5, 3, 7, 7, 200), (3, 200, 40)),
    ("temporal", (4, 2, 5, 5, 64), (3, 64, 200)),
    ("temporal", (32, 2, 7, 7, 1152), (3, 1152, 512))) \
    + F32_TEMPORAL_DATA_144_SHAPES
# the fp32 temporal filter gradient's frame walk off the train tiling (strips
# of 32): clips of one frame across strips (31 strips, the last of 20, in
# slices of 18 and 13) at C_out 40 (a masked N tile); five 7x7 clips of
# three frames several a strip, the last partial, at C_in 40 (one block of
# 48: a warp past C_in) and C_out 48, slices of 6 and 2; C_in 200 in five
# blocks of 48 (the last of 8) at C_out 40, slices of 9, 9 and 1; 85 7x7
# clips at C_in 280, 131 strips in 22 slices, the last of five; the stage-4
# train shape (32 clips: six slices of 9 strips, the last of 4); the
# channel blocks of 64
F32_TEMPORAL_FILTER_64_SHAPES = (
    # five 7x7 clips of three frames, 8 strips (the last of 21) in slices of
    # 6 and 2, at C_in 104 (two blocks of 64: the second's channels 112-127
    # leave its last warp idle) and C_out 40 (a masked N tile)
    ("temporal", (5, 3, 7, 7, 104), (3, 104, 40)),)
F32_TEMPORAL_FILTER_EDGE_SHAPES = (
    ("temporal", (20, 1, 7, 7, 24), (3, 24, 40)),
    ("temporal", (5, 3, 7, 7, 40), (3, 40, 48)),
    ("temporal", (12, 2, 7, 7, 200), (3, 200, 40)),
    ("temporal", (85, 3, 7, 7, 280), (3, 280, 40)),
    ("temporal", (32, 2, 7, 7, 1152), (3, 1152, 512))) \
    + F32_TEMPORAL_FILTER_64_SHAPES
# the fp32 frame walk off the serving tiling (forward only): clips of one
# frame across a strip; 7x7 clips five a strip, the second strip partial,
# C_in 40 (chunks of 16, 16, 8); C_out 200 in four N tiles of 64, the last
# masked; the stage-4 train shape (32 clips, C_out 512), 13 strips x 8 N
# tiles for 132 SMs
F32_FRAME_EDGE_SHAPES = (("temporal", (3, 1, 7, 7, 24), (3, 24, 40)),
                         ("temporal", (5, 3, 7, 7, 40), (3, 40, 48)),
                         ("temporal", (2, 3, 4, 7, 40), (3, 40, 200)),
                         ("temporal", (32, 2, 7, 7, 1152), (3, 1152, 512)))


def plan_f32(torch, conv_bn, kind, x, co):
    """The fp32 walk's plan as the phase lines carry it: the spatial row
    walk's step, N tile, K chunk and ranges (None: the gather); the
    temporal frame walk's strip, N tile, K chunk, register tile (positions
    x output channels x output frames a thread), resident or streamed
    filter and ranges."""
    if kind == "spatial":
        p = spatial_plan_f32(torch, conv_bn, x, co)
        return None if p is None else {"step": p.step, "n_tile": p.n_tile,
                                       "k_chunk": p.k_chunk,
                                       "ranges": p.ranges}
    p = temporal_plan_f32(torch, conv_bn, x, co)
    return {"strip": p.strip, "n_tile": p.n_tile, "k_chunk": p.k_chunk,
            "register_tile": "x".join(map(str, p.register_tile)),
            "filter": "resident" if p.resident else "streamed",
            "ranges": p.ranges}


def check_conv_f32(torch, F, conv_bn):
    """Rows 3f / 4f: the fp32 units against their plain versions at every
    fused unit's serving shape (longseq_eval with compute_dtype=float32: 128
    clips), at F32_EDGE_SHAPES, F32_WALK_EDGE_SHAPES,
    F32_GATHER_EDGE_SHAPES and F32_FRAME_EDGE_SHAPES, with the controls of
    ``check_fwd_unit_f32``;
    timed (kernel and library in turn, F32_FWD_ROUNDS rounds of
    F32_FWD_REPS) beside the plain version and ``F.conv3d`` in fp32 (no
    TF32) plus the sums. Returns the two rows of the kernels line, per
    served video."""
    g = torch.Generator(device="cuda").manual_seed(13)
    edges = {}
    for kind, xs, ws in (F32_EDGE_SHAPES + F32_WALK_EDGE_SHAPES
                         + F32_GATHER_EDGE_SHAPES + F32_FRAME_EDGE_SHAPES):
        for affine in (False, True):
            x, w, a = f32_unit_inputs(torch, g, xs, ws, affine)
            key = f"{kind}_{'x'.join(map(str, xs))}_to_{ws[-1]}_affine={affine}"
            plan = plan_f32(torch, conv_bn, kind, x, ws[-1])
            if (kind, xs, ws) in F32_GATHER_EDGE_SHAPES:
                require(plan is None, f"{key}: the row walk takes it: {plan}")
            edges[key] = check_fwd_unit_f32(
                torch, F, conv_bn, f"fp32 unit at edge shape {key}", x, w, a,
                kind) + (plan,)
            del x, w
        torch.cuda.empty_cache()
    out = {}
    for kind, xs, ws, affine, copies in _conv_units():
        x, w, a = f32_unit_inputs(torch, g, xs, ws, affine)
        what = f"fp32 conv unit {kind} {xs} affine={affine}"
        err, over, s1_ratio = check_fwd_unit_f32(torch, F, conv_bn, what, x,
                                                 w, a, kind)
        torch.cuda.empty_cache()
        plain = timed(torch, lambda: conv_bn.conv_unit_reference(
            x, w, *a, kind=kind), reps=F32_FWD_REPS)
        xhat = conv_bn._prologue(x, *a) if affine else x
        kern, pad = conv_bn._torch_kernel(w, kind)
        kern = kern.contiguous(memory_format=torch.channels_last_3d)

        def library():
            yl = F.conv3d(xhat.permute(0, 4, 1, 2, 3), kern, padding=pad)
            return yl.sum((0, 2, 3, 4)), (yl * yl).sum((0, 2, 3, 4))
        t = timed_alternating(torch, {
            "kernel": lambda: conv_bn.conv_unit_fwd(x, w, *a, kind=kind),
            "library": library}, rounds=F32_FWD_ROUNDS, reps=F32_FWD_REPS)
        (ms, ms_spread), (lib, lib_spread) = t["kernel"], t["library"]
        m = math.prod(xs[:-1])
        flops = 2 * conv_bn.tap_pairs(kind, *xs[:4]) * xs[-1] * ws[-1]
        nbytes = 4 * (x.numel() + w.numel() + m * ws[-1]
                      + (2 * xs[-1] if affine else 0) + 2 * ws[-1])
        emit({"phase": "kernel_conv_f32", "kind": kind, "x": list(xs),
              "w": list(ws), "affine": affine, "per_forward": copies,
              "plan": plan_f32(torch, conv_bn, kind, x, ws[-1]),
              "max_abs_err": err, "err_over_limit": over,
              "s1_err_over_limit": s1_ratio, "ms": ms, "ms_spread": ms_spread,
              "plain_ms": plain, "library_ms_conv3d_sums": lib,
              "library_ms_spread": lib_spread,
              "bound_ms": bound(nbytes, flops, PEAK_FP32)[0],
              "tflops": flops / ms / 1e9})
        name = f"conv_unit_{kind}_f32"
        acc = out.setdefault(kind, {"name": name, "max_abs_err": 0.0, "ms": 0.0,
                                    "plain_ms": 0.0, "library_ms": 0.0,
                                    "_ops": 0.0, "_bytes": 0.0})
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("_ops", flops / PEAK_FP32 * 1e3),
                       ("_bytes", nbytes / HBM * 1e3)):
            acc[key] += copies * v
        del x, xhat
        torch.cuda.empty_cache()
    for acc in out.values():
        t_ops, t_bytes = acc.pop("_ops"), acc.pop("_bytes")
        acc["bound_ms"] = max(t_ops, t_bytes)
        acc["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    emit({"phase": "kernel_conv_f32_edges",
          "max_abs_err_err_over_limit_s1_over_limit_plan": edges,
          "tol_rel": CONV_F32_REL, "tol_abs": CONV_F32_ABS})
    return [out["spatial"], out["temporal"]]


def f32_bwd_limits(torch, F, conv_bn, x, w, inv, shift, y, gy, gs1, gs2,
                   ref, dxa, dxa_ref, kind):
    """bwd_limits' dw and dinv / dshift limits, with the fp32 dx limit:
    BWD_F32_REL of (|ge| (*) |w| mirrored), through the mask and |inv|, plus
    BWD_F32_ABS."""
    lim = bwd_limits(torch, conv_bn, x, inv, shift, y, gy, gs1, gs2, ref, dxa,
                     dxa_ref, kind)
    kern, pad = conv_bn._torch_kernel(w.abs(), kind)
    s = F.conv3d(conv_bn._gy_eff(gy, y, gs1, gs2).abs().permute(0, 4, 1, 2, 3),
                 kern.flip(2, 3, 4).transpose(0, 1), padding=pad
                 ).permute(0, 2, 3, 4, 1)
    if inv is not None:
        s = s * ((x * inv + shift) > 0) * inv.abs()
    lim["dx"] = s.mul_(BWD_F32_REL).add_(BWD_F32_ABS)
    return lim


def plain_bwd_tf32(torch, conv_bn, *args, kind):
    """The control: the plain backward with its convs in TF32 (cuDNN's
    default for fp32, which the plain version's full_fp32 scope turns off)."""
    scope = conv_bn.full_fp32
    conv_bn.full_fp32 = contextlib.nullcontext
    torch.backends.cudnn.allow_tf32 = True
    try:
        return conv_bn.conv_unit_bwd_reference(*args, kind=kind)
    finally:
        conv_bn.full_fp32 = scope
        torch.backends.cudnn.allow_tf32 = False


def filter_plan_f32(torch, conv_bn, kind, x, co):
    """The fp32 filter gradient's plan for x [B, T, H, W, C_in] -> C_out
    (channel counts as the wrapper pads them): the temporal frame walk's,
    the spatial row walk's, or None (the spatial per-tap gather: images too
    wide)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = (*x.shape[:4], _round8(x.shape[-1]), _round8(co), sms)
    if kind == "temporal":
        return conv_bn.f32_temporal_filter_plan(*shape)
    return conv_bn.f32_spatial_filter_plan(*shape)


def data_plan_f32(torch, conv_bn, kind, x, co, affine):
    """The fp32 data gradient's plan for x [B, T, H, W, C_in] -> C_out
    (channel counts as the wrapper pads them), with the prologue or
    without: the temporal frame walk's, the spatial row walk's, or None
    (the spatial per-tap gather: images too wide)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = (*x.shape[:4], _round8(x.shape[-1]), _round8(co), sms)
    if kind == "temporal":
        return conv_bn.f32_temporal_data_plan(*shape, affine)
    return conv_bn.f32_spatial_data_plan(*shape)


def data_plan_line(p):
    """The data walk's plan as the phase lines carry it (None: the
    gather)."""
    if p is None:
        return None
    if hasattr(p, "strip"):             # the temporal frame walk
        return {"walk": "frames", "strip": p.strip, "n_tile": p.n_tile,
                "k_chunk": p.k_chunk,
                "register_tile": "x".join(map(str, p.register_tile)),
                "filter": "resident" if p.resident else "streamed",
                "units_per_range": p.units_per_range, "ranges": p.ranges,
                "blocks": p.blocks}
    return {"walk": "rows", "step": p.step, "n_tile": p.n_tile,
            "k_chunk": p.k_chunk, "images_per_range": p.images_per_range,
            "ranges": p.ranges, "k_splits": p.k_splits,
            "chunks_per_split": p.chunks_per_split, "blocks": p.blocks,
            "model_us": p.model_us}


def filter_plan_line(p):
    """The filter walk's plan as the phase lines carry it (None: the
    gather)."""
    if p is None:
        return None
    if hasattr(p, "strip"):             # the temporal frame walk
        return {"walk": "frames", "strip": p.strip, "n_tile": p.n_tile,
                "ci_blk": p.ci_blk,
                "register_tile": "x".join(map(str, p.register_tile)),
                "units_per_slice": p.units_per_slice, "slices": p.slices,
                "blocks": p.blocks, "threads": p.threads}
    return {"walk": "rows", "step": p.step, "n_tile": p.n_tile,
            "ci_blk": p.ci_blk,
            "register_tile": "x".join(map(str, p.register_tile)),
            "ring_rows": p.ring_rows, "slices": p.slices,
            "images_per_slice": p.images_per_slice, "blocks": p.blocks,
            "threads": p.threads}


def check_bwd_unit_f32(torch, F, conv_bn, what, x, w, a, gy, gs1, gs2, kind,
                       padding_controls=False):
    """One fp32 backward unit (rows 5f / 6f or 7f / 8f): the kernels against
    the plain version (TF32 off), dx and dw per element, dinv / dshift per
    channel (f32_bwd_limits); each check shown to refuse the wrong answers:
    the plain version under TF32 (its dx or dw), a dw from the taps 0 / 2
    swapped and a dx from the filter with them swapped (where they differ),
    a dw without its last slice's share and a dinv without its last partial
    row (where there are two), and with ``padding_controls`` a dx from ge
    formed through the formula in the padding (gs1 there) and a dw from x^
    formed through the prologue there (relu(shift)); a second call must
    give the same bits. Returns (errors, whether the TF32 control failed
    the check)."""
    inv, shift = a
    y = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)[0]
    dx, dinv, dshift = conv_bn.conv_unit_bwd_data(x, w, *a, y, gy, gs1, gs2,
                                                  kind=kind)
    dw = conv_bn.conv_unit_bwd_filter(x, *a, y, gy, gs1, gs2, kind=kind)
    ref = conv_bn.conv_unit_bwd_reference(x, w, *a, y, gy, gs1, gs2, kind=kind)
    if inv is not None:
        mask = (x * inv + shift) > 0
        dxa_ref = conv_bn.conv_unit_bwd_data_reference(
            x, w, None, None, y, gy, gs1, gs2, kind=kind)[0] * mask
        dxa = conv_bn.conv_unit_bwd_data(x, w, None, None, y, gy, gs1, gs2,
                                         kind=kind)[0] * mask
    else:
        dxa, dxa_ref = dx, ref[0]
    lim = f32_bwd_limits(torch, F, conv_bn, x, w, inv, shift, y, gy, gs1, gs2,
                         ref, dxa, dxa_ref, kind)
    got = (dx, dw, dinv, dshift)
    errs = {"dx": (dx - ref[0]).abs().max().item(),
            "dw": (dw - ref[1]).abs().max().item(),
            "dx_over_limit": ((dx - ref[0]).abs() / lim["dx"]).max().item(),
            "dw_over_limit": ((dw - ref[1]).abs() / lim["dw"]).max().item()}
    if dinv is not None:
        errs["dinv_over_limit"] = ((dinv - ref[2]).abs() / lim["dinv"]).max().item()
        errs["dshift_over_limit"] = ((dshift - ref[3]).abs()
                                     / lim["dshift"]).max().item()
    require(bwd_within(torch, got, ref, lim), f"{what}: backward off: {errs}")
    wrong = {}
    tf32 = plain_bwd_tf32(torch, conv_bn, x, w, *a, y, gy, gs1, gs2, kind=kind)
    wrong["plain_under_tf32"] = (tf32[0], tf32[1], dinv, dshift)
    if bool(((ref[1].flip(0) - ref[1]).abs() > lim["dw"]).any()):
        wrong["dw_taps_0_2_swapped"] = (dx, dw.flip(0), dinv, dshift)
    swapped = conv_bn.conv_unit_bwd_data_reference(
        x, w.flip(0), *a, y, gy, gs1, gs2, kind=kind)[0]
    if bool(((swapped - ref[0]).abs() > lim["dx"]).any()):
        wrong["dx_taps_0_2_swapped"] = (swapped, dw, dinv, dshift)
    b, t, h, wd, ci = x.shape
    co = gy.shape[-1]
    m = b * t * h * wd
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    walk = filter_plan_f32(torch, conv_bn, kind, x, co)
    fplan = walk or conv_bn.f32_bwd_filter_plan(b, t, h, wd, _round8(ci),
                                                _round8(co), sms)
    if fplan.slices > 1:
        keep = torch.zeros(m, 1, device=x.device)
        if kind == "temporal":          # the frame walk's last slice of
            pos = torch.arange(b * h * wd, device=x.device)   # strips, at
            start = walk.positions_of(walk.units_of(walk.slices - 1)[0])[0]
            keep[(pos >= start).reshape(b, 1, h * wd).expand(b, t, h * wd)
                 .reshape(m)] = 1       # every frame
        else:
            last = fplan.positions_of(fplan.slices - 1, m) if walk is None \
                else range(walk.images_of(walk.slices - 1)[0] * h * wd, m)
            keep[last.start:last.stop] = 1
        ge = (conv_bn._gy_eff(gy, y, gs1, gs2).reshape(m, co) * keep
              ).reshape(gy.shape)
        zero = torch.zeros(co, device=x.device)
        share = conv_bn.conv_unit_bwd_filter_reference(
            x, inv, shift, torch.zeros_like(y), ge, zero, zero, kind=kind)
        wrong["dw_last_slice_left_out"] = (dx, dw - share, dinv, dshift)
    dwalk = data_plan_f32(torch, conv_bn, kind, x, co, inv is not None)
    last = torch.zeros(m, dtype=torch.bool, device=x.device)
    if dwalk is None:                   # the gather's last range of tiles
        dplan = conv_bn.f32_bwd_data_plan(b, t, h, wd, _round8(ci), sms)
        rows = dplan.ranges
        last[(rows - 1) * dplan.tiles_per_range * 64:] = True
    elif kind == "temporal":            # the frame walk's last range of
        rows = dwalk.ranges             # strips, at every frame
        start = dwalk.positions_of(dwalk.units_of(rows - 1)[0])[0]
        pos = torch.arange(b * h * wd, device=x.device)
        last = (pos >= start).reshape(b, 1, h * wd).expand(b, t, h * wd) \
            .reshape(m)
    elif dwalk.k_splits == 1:           # the walk's last range of images
        rows = dwalk.ranges
        last[dwalk.images_of(rows - 1)[0] * h * wd:] = True
    else:                               # the split sum's last block of rows
        rows = dwalk.part_rows
        last[(rows - 1) * conv_bn._SDF_SUM_ROWS:] = True
    if inv is not None and rows > 1:
        share = (x * dxa_ref).reshape(m, ci)[last].sum(0)
        wrong["dinv_last_row_left_out"] = (dx, dw, dinv - share, dshift)
    if padding_controls:
        pad = (0, 0, 1, 1, 1, 1) if kind == "spatial" \
            else (0, 0, 0, 0, 0, 0, 1, 1)
        kern = conv_bn._torch_kernel(w, kind)[0]
        gep = conv_bn._gy_eff(F.pad(gy, pad), F.pad(y, pad), gs1, gs2)
        dxh = F.conv3d(gep.permute(0, 4, 1, 2, 3),
                       kern.flip(2, 3, 4).transpose(0, 1)).permute(0, 2, 3, 4, 1)
        if inv is not None:
            dxh = dxh * ((x * inv + shift) > 0) * inv
        wrong["dx_ge_through_formula_in_padding"] = (dxh, dw, dinv, dshift)
        if inv is not None:
            xhp = conv_bn._prologue(F.pad(x, pad), inv, shift)
            ksize = (1, 3, 3) if kind == "spatial" else (3, 1, 1)
            dk = torch.nn.grad.conv3d_weight(
                xhp.permute(0, 4, 1, 2, 3), (co, ci) + ksize,
                conv_bn._gy_eff(gy, y, gs1, gs2).permute(0, 4, 1, 2, 3))
            dk = dk[:, :, 0].permute(2, 3, 1, 0) if kind == "spatial" \
                else dk[:, :, :, 0, 0].permute(2, 1, 0)
            wrong["dw_x_through_prologue_in_padding"] = (dx, dk, dinv, dshift)
    passed = [k for k, v in wrong.items() if bwd_within(torch, v, ref, lim)]
    tf32_seen = "plain_under_tf32" not in passed
    require(not [k for k in passed if k != "plain_under_tf32"],
            f"{what}: the backward checks would pass: {passed}")
    dx2, dinv2, dshift2 = conv_bn.conv_unit_bwd_data(x, w, *a, y, gy, gs1, gs2,
                                                     kind=kind)
    dw2 = conv_bn.conv_unit_bwd_filter(x, *a, y, gy, gs1, gs2, kind=kind)
    require(torch.equal(dx2, dx) and torch.equal(dw2, dw) and (dinv is None or (
        torch.equal(dinv2, dinv) and torch.equal(dshift2, dshift))),
        f"{what}: a second call gave another dx, dw, dinv or dshift")
    errs["controls"] = sorted(wrong)
    errs["filter_plan"] = filter_plan_line(walk)
    errs["data_plan"] = data_plan_line(dwalk)
    return errs, tf32_seen


def f32_bwd_inputs(torch, g, xs, ws, affine, scale=1e-2):
    """fp32 x, w, (inv, shift) and cotangents for one backward unit; shift
    lies away from zero (|shift| >= 0.2, either sign), so a border formed as
    relu(shift) instead of zero fails."""
    x = torch.randn(*xs, device="cuda", generator=g)
    w = (torch.rand(*ws, device="cuda", generator=g) * 2 - 1) \
        / math.sqrt(math.prod(ws[:-1]))
    a = (None, None)
    if affine:
        sh = torch.randn(xs[-1], device="cuda", generator=g) * 0.1
        a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
             sh + 0.2 * torch.sign(sh))
    co = ws[-1]
    gy = torch.randn(*xs[:-1], co, device="cuda", generator=g) * scale
    gs1 = torch.randn(co, device="cuda", generator=g) * scale * 1e-3
    gs2 = torch.randn(co, device="cuda", generator=g) * scale * 1e-4
    return x, w, a, gy, gs1, gs2


F32_BWD_KERNELS = ("conv_spatial_bwd_data_f32", "conv_spatial_bwd_filter_f32",
                   "conv_temporal_bwd_data_f32", "conv_temporal_bwd_filter_f32")


def check_conv_f32_bwd(torch, F, conv_bn, clips=32):
    """Rows 5f-8f: the fp32 backward kernels against their plain versions
    (TF32 off) at F32_EDGE_SHAPES, F32_FILTER_WALK_EDGE_SHAPES,
    F32_DATA_WALK_EDGE_SHAPES, F32_TEMPORAL_DATA_EDGE_SHAPES (the frame
    walk required, in N tiles of 144 at F32_TEMPORAL_DATA_144_SHAPES),
    F32_TEMPORAL_FILTER_EDGE_SHAPES (the filter gradient's frame walk
    required at every temporal shape, in channel blocks of 64 at
    F32_TEMPORAL_FILTER_64_SHAPES; an empty batch's dw must be zero) and
    F32_GATHER_EDGE_SHAPES (the spatial filter and data
    gradients' per-tap gathers each taken at one of them at least), with
    and without the prologue and with the padding controls,
    then at every fused unit's shape of the fusion train step
    (``_train_units``), where the plain version under TF32 must fail the
    check; timed (kernel and library in turn, F32_BWD_ROUNDS rounds of
    F32_BWD_REPS) beside the plain version and cuDNN's
    ``torch.nn.grad.conv3d_input`` / ``conv3d_weight`` in fp32 (no TF32).
    Returns the four rows of the kernels line, per train step, each with
    its ms a launch per stage."""
    g = torch.Generator(device="cuda").manual_seed(19)
    edges, tf32_edges, gathered, data_gathered = {}, 0, [], []
    for kind, xs, ws in dict.fromkeys(
            F32_EDGE_SHAPES + F32_FILTER_WALK_EDGE_SHAPES
            + F32_DATA_WALK_EDGE_SHAPES + F32_TEMPORAL_DATA_EDGE_SHAPES
            + F32_TEMPORAL_FILTER_EDGE_SHAPES + F32_GATHER_EDGE_SHAPES):
        for affine in (False, True):
            x, w, a, gy, gs1, gs2 = f32_bwd_inputs(torch, g, xs, ws, affine,
                                                   scale=1.0)
            key = f"{kind}_{'x'.join(map(str, xs))}_to_{ws[-1]}_affine={affine}"
            edges[key], seen = check_bwd_unit_f32(
                torch, F, conv_bn, f"fp32 bwd at edge shape {key}", x, w, a,
                gy, gs1, gs2, kind, padding_controls=True)
            tf32_edges += seen
            if (kind, xs, ws) in F32_FILTER_WALK_EDGE_SHAPES:
                require(edges[key]["filter_plan"] is not None,
                        f"{key}: the filter gradient takes the gather")
            if (kind, xs, ws) in F32_DATA_WALK_EDGE_SHAPES:
                require(edges[key]["data_plan"] is not None,
                        f"{key}: the data gradient takes the gather")
            if kind == "temporal":
                require((edges[key]["data_plan"] or {}).get("walk")
                        == "frames", f"{key}: the temporal data gradient "
                        f"takes no frame walk: {edges[key]['data_plan']}")
                require((edges[key]["filter_plan"] or {}).get("walk")
                        == "frames", f"{key}: the temporal filter gradient "
                        f"takes no frame walk: {edges[key]['filter_plan']}")
            if (kind, xs, ws) in F32_TEMPORAL_DATA_144_SHAPES:
                require(edges[key]["data_plan"]["n_tile"] == 144,
                        f"{key}: the frame walk takes no N tile of 144: "
                        f"{edges[key]['data_plan']}")
            if (kind, xs, ws) in F32_TEMPORAL_FILTER_64_SHAPES:
                require(edges[key]["filter_plan"]["ci_blk"] == 64,
                        f"{key}: the filter frame walk takes no channel "
                        f"block of 64: {edges[key]['filter_plan']}")
            if (kind, xs, ws) in F32_GATHER_EDGE_SHAPES \
                    and edges[key]["filter_plan"] is None:
                gathered.append(key)
            if (kind, xs, ws) in F32_GATHER_EDGE_SHAPES \
                    and edges[key]["data_plan"] is None:
                data_gathered.append(key)
            del x, w, gy
        torch.cuda.empty_cache()
    require(gathered, "no F32_GATHER_EDGE_SHAPES took the spatial filter "
            "gradient's per-tap gather")
    require(data_gathered, "no F32_GATHER_EDGE_SHAPES took the spatial data "
            "gradient's per-tap gather")
    # an empty batch: the temporal filter walk's C entry sets dw to 0
    x, _, a, gy, gs1, gs2 = f32_bwd_inputs(
        torch, torch.Generator(device="cuda").manual_seed(25),
        (0, 2, 7, 7, 48), (3, 48, 64), True, scale=1.0)
    dw = conv_bn.conv_unit_bwd_filter(x, *a, gy, gy, gs1, gs2,
                                      kind="temporal")
    torch.cuda.synchronize()
    require(tuple(dw.shape) == (3, 48, 64) and not dw.any().item(),
            f"the temporal filter gradient of an empty batch is not a zero "
            f"[3, 48, 64]: {tuple(dw.shape)}")
    del x, gy, dw
    emit({"phase": "kernel_conv_f32_bwd_edges", "errors": edges,
          "tf32_control_failed_at": tf32_edges, "of": len(edges),
          "filter_gather_at": gathered, "data_gather_at": data_gathered,
          "tol_dx_rel": BWD_F32_REL, "tol_dw_rel": BWD_DW_REL})
    out = {}
    for kind, xs, ws, affine, copies in _train_units(clips):
        x, w, a, gy, gs1, gs2 = f32_bwd_inputs(torch, g, xs, ws, affine)
        what = f"fp32 conv unit bwd {kind} {xs} affine={affine}"
        errs, seen = check_bwd_unit_f32(torch, F, conv_bn, what, x, w, a, gy,
                                        gs1, gs2, kind)
        require(seen, f"{what}: the plain version under TF32 passes the "
                "check: it cannot see TF32")
        torch.cuda.empty_cache()
        y = conv_bn.conv_unit_fwd(x, w, *a, kind=kind)[0]
        xh = conv_bn._prologue(x, *a)
        ge = conv_bn._gy_eff(gy, y, gs1, gs2)
        kern, pad = conv_bn._torch_kernel(w, kind)
        kern = kern.contiguous(memory_format=torch.channels_last_3d)
        xn, gn = xh.permute(0, 4, 1, 2, 3), ge.permute(0, 4, 1, 2, 3)
        xshape = (xs[0], xs[-1]) + tuple(xs[1:4])
        t = timed_alternating(torch, {
            "data": lambda: conv_bn.conv_unit_bwd_data(x, w, *a, y, gy, gs1,
                                                       gs2, kind=kind),
            "data_library": lambda: torch.nn.grad.conv3d_input(
                xshape, kern, gn, padding=pad),
            "filter": lambda: conv_bn.conv_unit_bwd_filter(x, *a, y, gy, gs1,
                                                           gs2, kind=kind),
            "filter_library": lambda: torch.nn.grad.conv3d_weight(
                xn, kern.shape, gn, padding=pad)},
            rounds=F32_BWD_ROUNDS, reps=F32_BWD_REPS)
        plain = {"data": timed(torch, lambda: conv_bn.conv_unit_bwd_data_reference(
                     x, w, *a, y, gy, gs1, gs2, kind=kind), reps=F32_BWD_REPS),
                 "filter": timed(torch, lambda: conv_bn.conv_unit_bwd_filter_reference(
                     x, *a, y, gy, gs1, gs2, kind=kind), reps=F32_BWD_REPS)}
        m, ci, co = math.prod(xs[:-1]), xs[-1], ws[-1]
        flops = 2 * conv_bn.tap_pairs(kind, *xs[:4]) * ci * co
        vec = 4 * (2 * co + (2 * ci if affine else 0))
        nbytes = {"data": 4 * (2 * m * co + w.numel() + m * ci
                               + (m * ci + 2 * ci if affine else 0)) + vec,
                  "filter": 4 * (m * ci + 2 * m * co + w.numel()) + vec}
        for part in ("data", "filter"):
            (ms, spread), (lib, lib_spread) = t[part], t[part + "_library"]
            emit({"phase": f"kernel_conv_f32_bwd_{part}", "kind": kind,
                  "x": list(xs), "w": list(ws), "affine": affine,
                  "per_step": copies, "errors": errs,
                  "plan": errs[f"{part}_plan"],
                  "ms": ms,
                  "ms_spread": spread, "plain_ms": plain[part],
                  "library_ms": lib, "library_ms_spread": lib_spread,
                  "tflops": flops / ms / 1e9,
                  "bound_ms": bound(nbytes[part], flops, PEAK_FP32)[0]})
            name = f"conv_{kind}_bwd_{part}_f32"
            acc = out.setdefault(name, {"name": name, "max_abs_err": 0.0,
                                        "ms": 0.0, "plain_ms": 0.0,
                                        "library_ms": 0.0, "_ops": 0.0,
                                        "_bytes": 0.0, "ms_per_stage": []})
            acc["ms_per_stage"].append({"x": list(xs), "affine": affine,
                                        "per_step": copies, "ms": ms,
                                        "library_ms": lib})
            acc["max_abs_err"] = max(acc["max_abs_err"],
                                     errs["dx" if part == "data" else "dw"])
            for key, v in (("ms", ms), ("plain_ms", plain[part]),
                           ("library_ms", lib),
                           ("_ops", flops / PEAK_FP32 * 1e3),
                           ("_bytes", nbytes[part] / HBM * 1e3)):
                acc[key] += copies * v
        del x, y, gy, xh, ge, xn, gn
        torch.cuda.empty_cache()
    for acc in out.values():
        t_ops, t_bytes = acc.pop("_ops"), acc.pop("_bytes")
        acc["bound_ms"] = max(t_ops, t_bytes)
        acc["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return [out[k] for k in F32_BWD_KERNELS]


def _lane_units(clips):
    """(kind, x shape, w shape, affine) of the fused units of R(2+1)D-18 with
    mid_mode="lane" over ``clips`` clips: midplanes 128 / 256 / 512 / 1152."""
    units = []
    for c, t, s in ((64, 16, 56), (128, 8, 28), (256, 4, 14), (512, 2, 7)):
        mid = max(128, ((27 * c * c) // (12 * c) + 63) // 128 * 128)
        units += [("spatial", (clips, t, s, s, c), (3, 3, c, mid), False),
                  ("spatial", (clips, t, s, s, c), (3, 3, c, mid), True),
                  ("temporal", (clips, t, s, s, mid), (3, mid, c), True)]
    return units


def check_lane(torch, F, conv_bn):
    """Rows 3-8 at the lane widths (phase kernel_lane): the forward units at
    the serving shapes (128 clips) and the backward at the train shapes (32
    clips), each against its plain version under the bf16 limits and
    controls of check_fwd_unit / check_bwd_unit; the planners' tilings at
    widths 128 / 256 / 512 (they were sized at 144 / 288 / 576)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    errs = {}
    for kind, xs, ws, affine in _lane_units(128):
        x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
        w = (torch.rand(*ws, device="cuda", generator=g) * 2 - 1) \
            / math.sqrt(math.prod(ws[:-1]))
        a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
             torch.randn(xs[-1], device="cuda", generator=g) * 0.1) \
            if affine else (None, None)
        key = f"fwd_{kind}_{xs[-1]}_to_{ws[-1]}_affine={affine}"
        errs[key] = check_fwd_unit(torch, F, conv_bn, f"lane unit {key}", x, w,
                                   a, kind)
        del x
        torch.cuda.empty_cache()
    for kind, xs, ws, affine in _lane_units(32):
        x = torch.randn(*xs, device="cuda", generator=g).to(torch.bfloat16)
        w = ((torch.rand(*ws, device="cuda", generator=g) * 2 - 1)
             / math.sqrt(math.prod(ws[:-1]))).to(torch.bfloat16)
        a = (torch.rand(xs[-1], device="cuda", generator=g) + 0.5,
             torch.randn(xs[-1], device="cuda", generator=g) * 0.1) \
            if affine else (None, None)
        co = ws[-1]
        gy = (torch.randn(*xs[:-1], co, device="cuda", generator=g) * 1e-2
              ).to(torch.bfloat16)
        gs1 = torch.randn(co, device="cuda", generator=g) * 1e-5
        gs2 = torch.randn(co, device="cuda", generator=g) * 1e-6
        key = f"bwd_{kind}_{xs[-1]}_to_{co}_affine={affine}"
        _, errs[key] = check_bwd_unit(torch, conv_bn, f"lane unit {key}", x, w,
                                      *a, gy, gs1, gs2, kind)
        del x, gy
        torch.cuda.empty_cache()
    emit({"phase": "kernel_lane", "widths": [128, 256, 512, 1152],
          "errors": errs})


# (name, overrides) of the served backbones beside R(2+1)D-18 in bf16
BACKBONES = (("conv_mode=3d", {"model.visual.conv_mode": "3d"}),
             ("conv_mode=mc3", {"model.visual.conv_mode": "mc3"}),
             ("se_ratio=16", {"model.visual.se_ratio": 16}),
             ("stem_s2d=true", {"model.visual.stem_s2d": True}),
             ("mid_mode=lane", {"model.visual.mid_mode": "lane"}),
             ("compute_dtype=float32", {"model.compute_dtype": "float32"}))


def backbone_launches(cuda_lib, cfg, fused_blocks, per=1):
    """The launches a served video (``per`` = 1) or ``per`` train steps of
    ``cfg`` must make: the mel and GRU kernels, and 2 units a fused block
    (10 at R(2+1)D-18) of each kind, fp32 or bf16, forward (and in
    training backward)."""
    want = {k: 0 for k in cuda_lib.launches}
    want["melspec"] = per
    want["gru"] = per * cfg.model.gru.num_layers
    sfx = "_f32" if cfg.model.compute_dtype == "float32" else ""
    for kind in ("spatial", "temporal"):
        want[f"conv_{kind}{sfx}"] = 2 * fused_blocks * per
    return want


def _clips_of(torch, np, frames, starts, length, dtype, device):
    """[len(starts), length, S, S, 3] clips of a uint8 video, /255 in dtype."""
    x = np.stack([frames[s:s + length] for s in starts])
    return torch.from_numpy(x).to(device=device, dtype=dtype) / 255.0


def serve_backbones(torch, np, cuda_lib, Predictor, frames, wav):
    """Every BACKBONES configuration served at full width (longseq_eval and
    one override, seeded random weights): the 1024-frame video's
    predict_video (frames/s after a warm run, peak memory, launches per
    kernel held to backbone_launches); then the same configuration at full
    width on 32x32 frames, W = 2, card against CPU on a 48-frame video
    (bf16 within PATH_ATOL / PATH_MEAN_ATOL, fp32 within F32_PATH_ATOL /
    F32_PATH_MEAN_ATOL) and, for fp32, the backbone's per-frame features of
    its five clips within F32_FEAT_REL, with TF32 turned on for the
    library's convs as the control that must exceed it. Returns the fp32
    configuration's launches."""
    rng = np.random.RandomState(21)
    small_f = rng.randint(0, 256, (48, 32, 32, 3), dtype=np.uint8)
    small_w = (rng.randn(int(48 / 30 * 16000) + 16000) * 0.1).astype(np.float32)
    counts_f32 = None
    for name, ov in BACKBONES:
        p = Predictor(preset="longseq_eval", overrides=ov)
        fp32 = p.cfg.model.compute_dtype == "float32"
        fused = p.model.visual.fused_blocks
        want = backbone_launches(cuda_lib, p.cfg, fused)
        p.predict_video(frames=frames, waveform=wav)          # warm run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pred, counts, dt = serve(torch, np, cuda_lib, p, frames, wav,
                                 kernels=[k for k, v in want.items() if v])
        require(counts == want, f"{name}: launches {counts}, expected {want}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        if fp32:
            counts_f32 = counts
        del p
        torch.cuda.empty_cache()
        small = dict(ov, **{"window.windows_per_clip": 2, "data.image_size": 32})
        pc = Predictor(preset="longseq_eval", overrides=small, device="cpu")
        pg = Predictor(preset="longseq_eval", overrides=small)
        pg.model.load_state_dict(pc.model.state_dict())
        a = pc.predict_video(frames=small_f, waveform=small_w)["pred"]
        b = pg.predict_video(frames=small_f, waveform=small_w)["pred"]
        d = np.abs(a - b)
        tol = (F32_PATH_ATOL, F32_PATH_MEAN_ATOL) if fp32 \
            else (PATH_ATOL, PATH_MEAN_ATOL)
        require(d.max() <= tol[0] and d.mean() <= tol[1],
                f"{name}: card vs CPU preds max {d.max()}, mean {d.mean()}")
        res = {"phase": "serve_backbones", "config": name, "frames": 1024,
               "s": dt, "frames_per_s": 1024 / dt, "peak_mem_gb": peak,
               "launches": counts, "fused_blocks": fused,
               "card_vs_cpu": {"frames": 48, "image_size": 32,
                               "max_abs_diff": float(d.max()),
                               "mean_abs_diff": float(d.mean()),
                               "tol_max": tol[0], "tol_mean": tol[1]}}
        if fp32:
            starts = list(range(0, 48 - 16 + 1, 8))
            with torch.no_grad():
                want_f = pc.model.visual(_clips_of(
                    torch, np, small_f, starts, 16, torch.float32, "cpu"),
                    per_frame=True)
                clips = _clips_of(torch, np, small_f, starts, 16,
                                  torch.float32, "cuda")
                with pg.model.precision():
                    got_f = pg.model.visual(clips, per_frame=True).cpu()
                # the control: TF32 in cuDNN's convs, outside the scope
                torch.backends.cudnn.allow_tf32 = True
                try:
                    tf32_f = pg.model.visual(clips, per_frame=True).cpu()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
            scale = want_f.abs().max().item()
            rel = (got_f - want_f).abs().max().item() / scale
            rel_tf32 = (tf32_f - want_f).abs().max().item() / scale
            require(rel <= F32_FEAT_REL, f"{name}: backbone features card vs "
                    f"CPU {rel} of their largest > {F32_FEAT_REL}")
            require(rel_tf32 > F32_FEAT_REL, f"{name}: TF32 features within "
                    f"the fp32 limit ({rel_tf32}): the check cannot see TF32")
            res["features_card_vs_cpu"] = {"rel": rel, "tf32_rel": rel_tf32,
                                           "tol_rel": F32_FEAT_REL}
        emit(res)
        del pc, pg
        torch.cuda.empty_cache()
    return counts_f32


def train_backbones(torch, np, cuda_lib, config, Trainer, data):
    """Two full-width fusion steps of every configuration of BACKBONES
    (fp32 through rows 3f-8f) through Trainer.fit: finite losses, launches
    held to backbone_launches and the backward kernels of the
    configuration's dtype (2 a fused block and step each; none of the
    other dtype's), s/step (the second step, between the ends of both),
    peak memory."""
    for name, ov in BACKBONES:
        cfg = config.apply_overrides(config.fusion(),
                                     {**ov, "train.log_every": 1})
        tr = Trainer(cfg)
        stream = synthetic_stream(np, cfg, *data, seed=0)
        fused = tr.model.visual.fused_blocks
        want = backbone_launches(cuda_lib, cfg, fused, per=2)
        sfx = "_f32" if cfg.model.compute_dtype == "float32" else ""
        for k in ("spatial", "temporal"):
            for part in ("data", "filter"):
                want[f"conv_{k}_bwd_{part}{sfx}"] = 2 * fused * 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        ends = []
        _, hist = tr.fit(stream, num_steps=2,
                         log=lambda s: ends.append(time.perf_counter()))
        torch.cuda.synchronize()
        counts = dict(cuda_lib.launches)
        require(counts == want, f"train {name}: launches {counts}, "
                f"expected {want}")
        loss = hist["loss"]
        require(len(loss) == 2 and all(math.isfinite(v) for v in
                                       loss + hist["grad_norm"]),
                f"train {name}: loss {loss}, grad norm {hist['grad_norm']}")
        emit({"phase": "train_backbones", "config": name, "steps": 2,
              "s_per_step": ends[1] - ends[0], "loss": loss,
              "grad_norm": hist["grad_norm"], "launches": counts,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del tr
        torch.cuda.empty_cache()


def train_fp32(torch, np, cuda_lib, config, Trainer, data):
    """fusion with compute_dtype=float32 trains on the card through
    Trainer.fit: 2 warm steps, then a second fit of F32_TRAIN_STEPS steps
    (from the seed again) with the counters set to 0 just before; its
    launches must be exactly the fp32 kernels' per-step counts (rows 3f-8f
    10 a step each, no bf16 conv kernel), its losses and grad norms finite
    and its params moved (s/step between the ends of its first and last
    step, peak memory). Returns its launches."""
    cfg = config.apply_overrides(config.fusion(), {
        "model.compute_dtype": "float32", "train.log_every": 1})
    tr = Trainer(cfg)
    stream = synthetic_stream(np, cfg, *data, seed=0)
    tr.fit(stream, num_steps=2, log=lambda s: None)             # warm
    before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = F32_TRAIN_STEPS
    cuda_lib.reset_launches()
    ends = []
    t0 = time.perf_counter()
    _, hist = tr.fit(stream, num_steps=steps,
                     log=lambda s: ends.append(time.perf_counter()))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    per_step = {"melspec": 1, "gru": cfg.model.gru.num_layers,
                "conv_spatial_f32": 10, "conv_temporal_f32": 10,
                **{k: 10 for k in F32_BWD_KERNELS}}
    want = {k: per_step.get(k, 0) * steps for k in cuda_lib.launches}
    require(counts == want, f"fp32 train launches {counts}, expected {want}")
    loss, gnorm = hist["loss"], hist["grad_norm"]
    require(len(loss) == steps and all(math.isfinite(v) for v in loss + gnorm),
            f"fp32 train loss {loss}, grad norm {gnorm}")
    moved = max((p.detach() - before[n]).abs().max().item()
                for n, p in tr.model.named_parameters())
    require(moved > 0, "the fp32 params did not move")
    step_s = (ends[-1] - ends[0]) / (steps - 1)
    emit({"phase": "train_fp32", "batch": cfg.train.batch_size,
          "windows": cfg.window.windows_per_clip, "steps": steps,
          "launches": counts, "s": dt, "s_per_step": step_s,
          "clips_per_s": cfg.train.batch_size * cfg.window.windows_per_clip
          / step_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss": loss, "grad_norm": gnorm, "max_param_move": moved})
    del tr
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The data layer and the CLI: the port's JPEG loader, a fake ABAW tree made
# from the committed fixtures, and ``m3f_torch.main`` driven as a user would
# ---------------------------------------------------------------------------

FIXTURES = os.path.join("tests", "data", "torch_crops")
LOADER_FRAMES = 1024     # decoded in phase data_loader (the 16 fixtures, cycled)
LOADER_TOL = 2           # levels, against the committed reference decode
#                          (tests/test_native_loader.py:37-39); 0 expected:
#                          libjpeg, or the port's own decoder where the host
#                          has no libjpeg headers, is libjpeg's decode bit
#                          for bit
# the fake tree: {video: (frames, fps of its wav, wav tail in s)}
ABAW_TRAIN = {"vid_a": (1024, 30.0, 0.0), "vid_tail": (1024, 30.0, 0.06),
              "vid_25": (900, 25.0, 0.0)}
ABAW_VAL = {"vid_v": (512, 30.0, 0.0)}
ABAW_TEST = ("vid_t", 700, range(301, 341))   # 1-based crops missing
ABAW_INVALID = range(100, 120)                # frames labelled -5
CLI_STEPS = (8, 12, 10)  # train, resumed train, --resume-from (+2 steps)
RESUME_LOSS_ATOL = 1e-3  # resume_jax_layout: the losses of steps 3-4 resumed
#                          from the optax-layout checkpoint against 4
#                          uninterrupted steps (equal where every kernel and
#                          cuDNN call repeats its bits) ...
RESUME_PARAM_REL = 0.05  # ... and the params (L2) within 0.05 of the move of
#                          steps 3-4
DDP_STEPS = 3            # ddp_train / ddp_two_ranks: train steps
DDP_LOSS_RTOL = 1e-3     # ddp_two_ranks against world size 1 on the same
#                          global batches: the first step's loss (bf16; BN
#                          sums of two halves summed in another order) ...
DDP_GNORM_RTOL = 1e-2    # ... its gradient norm (a world-size factor would
#                          be 0.5 or 2) ...
DDP_LATER_LOSS_ATOL = 1e-2   # ... and the later steps' losses
DDP_WITNESS_LOSS_RTOL = 1e-4    # both ranks on the same 16 clips (a global
DDP_WITNESS_GNORM_RTOL = 1e-3   # batch of those 16 twice) against one
DDP_WITNESS_LATER_ATOL = 1e-2   # process on the 16: the collectives alone
# faults planted in the rank processes (``planted_fault``); in one step each
# must break a limit above against world size 1, or leave the two ranks with
# BatchNorm running means that differ (a rank that normalised with its own
# half's statistics keeps its own)
DDP_FAULTS = ("bn_sums_unreduced", "bn_sums_local", "grads_averaged")
DDP_EVAL_FRAMES = 700    # the eval video of ddp_two_ranks
DDP_EVAL_SEQS = 3        # sequences of the sharded sequence forward (odd)
DDP_EVAL_ATOL = 1e-2     # sharded eval against one process, and the ranks'
#                          stitched tracks against each other (predictions
#                          in [-1, 1]; bf16, other per-rank batch shapes)


def data_loader(np, native_loader, repo):
    """The port's JPEG loader: built from ``csrc/loader.cc`` for this host
    (timed), LOADER_FRAMES fixture paths plus a missing and a corrupt file
    decoded at 112 in one call, each frame held to the committed reference
    decode within LOADER_TOL, the two bad slots zeroed with ok=False;
    frames/s on the host clock (the median of 5 calls after a warm one).
    Each call alternates with one of ``cv2.imread`` on a pool of as many
    threads decoding the same fixtures (``scripts/loader_bench.py``), the
    alternative to a native decoder, timed here in the process that trains
    (null without cv2)."""
    from concurrent.futures import ThreadPoolExecutor
    from m3f_torch.scripts.loader_bench import cv2_pool_decode
    t0 = time.perf_counter()
    native_loader.build()
    build_s = time.perf_counter() - t0
    require(native_loader.native_available(), "the JPEG loader did not load")
    ref = np.load(os.path.join(repo, FIXTURES, "reference_decode.npz"))["frames"]
    fx = [os.path.join(repo, FIXTURES, f"{i:05d}.jpg") for i in range(1, 17)]
    bad_dir = os.path.join(repo, "build", "data_loader")
    os.makedirs(bad_dir, exist_ok=True)
    corrupt = os.path.join(bad_dir, "corrupt.jpg")
    with open(corrupt, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0not really a jpeg")
    paths = [fx[i % 16] for i in range(LOADER_FRAMES)]
    paths += [os.path.join(bad_dir, "missing.jpg"), corrupt]
    try:
        import cv2  # noqa: F401
    except ImportError:
        cv2 = None
    workers = min(8, os.cpu_count() or 1)        # the loader's threads
    pool_out = np.empty((LOADER_FRAMES, 112, 112, 3), np.uint8)
    native_loader.decode_jpeg_batch(fx, 112)                     # warm
    times, pool_times = [], []
    with ThreadPoolExecutor(workers) as pool:
        if cv2 is not None:
            cv2_pool_decode(paths[:LOADER_FRAMES], 112, pool, workers, pool_out)
        for _ in range(5):
            t0 = time.perf_counter()
            frames, ok = native_loader.decode_jpeg_batch(paths, 112)
            times.append(time.perf_counter() - t0)
            if cv2 is not None:
                t0 = time.perf_counter()
                cv2_pool_decode(paths[:LOADER_FRAMES], 112, pool, workers,
                                pool_out)
                pool_times.append(time.perf_counter() - t0)
    require(bool(ok[:LOADER_FRAMES].all()), "a fixture did not decode")
    require(not ok[LOADER_FRAMES:].any()
            and not frames[LOADER_FRAMES:].any(), "bad files not zeroed")
    d = np.abs(frames[:LOADER_FRAMES].astype(np.int16)
               - ref[np.arange(LOADER_FRAMES) % 16].astype(np.int16))
    err = int(d.max())
    require(err <= LOADER_TOL, f"decode differs from the reference by {err}")
    s = statistics.median(times)
    alt = None
    if pool_times:
        alt = {"threads": workers, "s": pool_times,
               "frames_per_s": LOADER_FRAMES / statistics.median(pool_times),
               "max_abs_diff": int(np.abs(
                   pool_out.astype(np.int16)
                   - ref[np.arange(LOADER_FRAMES) % 16].astype(np.int16)).max())}
    emit({"phase": "data_loader", "backend": native_loader.backend(),
          "build_s": build_s, "frames": LOADER_FRAMES, "size": 112,
          "max_abs_diff": err, "share_differing": float((d > 0).mean()),
          "tol": LOADER_TOL, "s": times, "frames_per_s": LOADER_FRAMES / s,
          "cv2_pool": alt})


def _write_wav(np, path, n_samples, seed):
    import wave
    rng = np.random.RandomState(seed)
    t = np.arange(n_samples) / 16000.0
    x = 0.2 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(n_samples)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def build_fake_abaw(np, repo):
    """The ABAW layout under build/abaw_fake/: crops are copies of the
    fixtures in a seeded order per video, PCM16 wavs, annotations with -5
    rows (ABAW_INVALID); train two 1024-frame 30 fps videos (one wav with a
    60 ms tail) and a 900-frame one whose wav makes it 25 fps, val one of
    512 frames, test a 700-frame crop dir without annotation and with
    crops 301-340 missing. No containers."""
    root = os.path.join(repo, "build", "abaw_fake")
    shutil.rmtree(root, ignore_errors=True)
    ann = os.path.join(root, "annotations", "VA_Estimation_Challenge")
    fx = [os.path.join(repo, FIXTURES, f"{i:05d}.jpg") for i in range(1, 17)]
    os.makedirs(os.path.join(root, "audio"))
    seed = 0

    def crops(vid, n, skip=()):
        d = os.path.join(root, "cropped_aligned", vid)
        os.makedirs(d)
        order = np.random.RandomState(seed).randint(0, 16, n)
        for i in range(1, n + 1):
            if i not in skip:
                shutil.copyfile(fx[order[i - 1]], os.path.join(d, f"{i:05d}.jpg"))

    for split, videos in (("Train_Set", ABAW_TRAIN), ("Validation_Set", ABAW_VAL)):
        os.makedirs(os.path.join(ann, split))
        for vid, (n, fps, tail) in videos.items():
            seed += 1
            crops(vid, n)
            t = np.arange(n) / fps
            with open(os.path.join(ann, split, vid + ".txt"), "w") as f:
                f.write("valence,arousal\n")
                for i in range(n):
                    f.write("-5,-5\n" if i in ABAW_INVALID else
                            f"{0.7 * np.sin(0.9 * t[i]):.3f},"
                            f"{0.6 * np.cos(0.7 * t[i]):.3f}\n")
            _write_wav(np, os.path.join(root, "audio", vid + ".wav"),
                       int(round((n / fps + tail) * 16000)), seed)
    vid, n, gap = ABAW_TEST
    seed += 1
    crops(vid, n, skip=gap)
    _write_wav(np, os.path.join(root, "audio", vid + ".wav"),
               int(round(n / 30.0 * 16000)), seed)
    return root


def cli(main, argv, log_dir, name):
    """``main(argv)`` with its standard output kept in ``log_dir/name.log``
    (and returned); the log's tail goes to stderr if the call raises."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    except BaseException:
        print(buf.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, name + ".log"), "w") as f:
            f.write(buf.getvalue())
    require(rc == 0, f"{name}: exit code {rc}")
    return buf.getvalue()


def _steps_logged(out):
    return [int(l.split()[1].split("/")[0]) for l in out.splitlines()
            if l.startswith("step ")]


def _step_s(ck_dir, clips):
    """{step: s} from the run's train.jsonl (clips/s of each logged step,
    log_every=1: the time since the previous log, so an eval or checkpoint
    after a step's log falls into the next step's)."""
    rows = [json.loads(l) for l in open(os.path.join(ck_dir, "train.jsonl"))]
    return {r["step"]: clips / r["clips_per_sec"] for r in rows
            if "clips_per_sec" in r}


def _s_per_step(np, ck_dir, clips, steps):
    """Median s/step over ``steps`` (``_step_s``)."""
    got = _step_s(ck_dir, clips)
    require(set(steps) <= set(got), f"train.jsonl steps {sorted(got)}")
    return float(np.median([got[k] for k in steps]))


PRODUCER_BATCHES = 16    # batches timed through the CLI's input alone


def _producer(np, config, train_stream, root):
    """The CLI's train input alone (``main.train_stream`` over the fake
    tree, hop-aware, through its Prefetcher), no model: host s per batch
    over PRODUCER_BATCHES after a first one."""
    from m3f_torch.data.affwild2 import AffWild2Dataset
    cfg = config.apply_overrides(config.fusion(), {"data.synthetic": False,
                                                   "data.root": root})
    ds = AffWild2Dataset(cfg.data, cfg.model.mel, split="train")
    stream = train_stream(cfg, ds, True)(0)
    try:
        next(stream)
        t = [time.perf_counter()]
        for _ in range(PRODUCER_BATCHES):
            next(stream)
            t.append(time.perf_counter())
    finally:
        stream.close()
    d = np.diff(t)
    return {"batches": PRODUCER_BATCHES, "median_s": float(np.median(d)),
            "mean_s": float(d.mean()), "batches_per_s": float(1 / d.mean())}


def cli_doctor(np, main, root, log_dir):
    out = cli(main, ["doctor", "--json", "data.root=" + root], log_dir,
              "cli_doctor")
    rows = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    off = sorted(r["video"] for r in rows if r["fps"] != 30.0)
    require(off == ["vid_25"], f"off-rate videos {off}, expected ['vid_25']")
    require(not any(r["errors"] for r in rows), f"doctor errors: {rows}")
    emit({"phase": "cli_doctor", "videos": len(rows), "off_rate": off,
          "fps": {r["video"]: r["fps"] for r in rows}})


def cli_train(torch, np, cuda_lib, config, main, train_stream, root, repo,
              log_dir):
    """``train --preset fusion`` at full width on the fake tree: 8 steps
    with an eval and a checkpoint every 4 and a trace; hop-aware windowing
    on, every train step's mel call given a per-entry hop that holds the
    25 fps hop, every kernel of rows 1-8 launched (the backward kernels 10
    a step); checkpoints 4, 8 and best; then 12 steps resumed from step 8
    (4 steps), and a fresh directory seeded from step 8 by --resume-from;
    each step's time (train.jsonl), and the input alone (``_producer``)."""
    from m3f_torch.models import m3f as m3f_model
    ck = os.path.join(repo, "build", "cli_train")
    trace_dir = os.path.join(ck, "trace")
    for d in (ck, ck + "_seeded"):
        shutil.rmtree(d, ignore_errors=True)
    cfg = config.fusion()
    # options first, then the key=value overrides (argparse)
    common = ["data.synthetic=false", "data.root=" + root,
              "train.eval_every=4", "train.checkpoint_every=4",
              "train.log_every=1"]
    hops = []
    real = m3f_model.log_mel_spectrogram

    def spy(*a, **kw):
        if torch.is_grad_enabled() and isinstance(kw.get("hop"), torch.Tensor):
            hops.append(sorted(set(kw["hop"].flatten().tolist())))
        return real(*a, **kw)
    m3f_model.log_mel_spectrogram = spy
    try:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        out = cli(main, ["train", "--preset", "fusion", *common,
                         "train.num_steps=8",
                         "train.checkpoint_dir=" + ck,
                         "train.profile_dir=" + trace_dir], log_dir, "cli_train")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(cuda_lib.launches)
    finally:
        m3f_model.log_mel_spectrogram = real
    steps = CLI_STEPS[0]
    require("hop-aware windowing enabled" in out, "hop-aware windowing is off")
    hop25 = cfg.model.mel.hop_for_fps(25.0, cfg.data.fps)
    require(len(hops) == steps and any(hop25 in h for h in hops),
            f"train-step mel hops {hops}, expected the 25 fps hop {hop25}")
    missing = [k for k in FORWARD_KERNELS if counts[k] < steps]
    missing += [k for k in BWD_KERNELS if counts[k] != 10 * steps]
    require(not missing, f"cli_train launches {counts}")
    for name in ("ckpt_00000004.npz", "ckpt_00000008.npz", "best.npz"):
        require(os.path.exists(os.path.join(ck, name)), f"no {name}")
    require(_steps_logged(out) == list(range(1, steps + 1)), "steps logged")
    clips = cfg.train.batch_size * cfg.window.windows_per_clip
    step_s = _s_per_step(np, ck, clips, range(2, steps + 1))
    out2 = cli(main, ["train", "--preset", "fusion", *common,
                      f"train.num_steps={CLI_STEPS[1]}",
                      "train.checkpoint_dir=" + ck], log_dir, "cli_train_resume")
    resumed = _steps_logged(out2)
    require(resumed == list(range(steps + 1, CLI_STEPS[1] + 1)),
            f"the resumed run logged steps {resumed}")
    require(os.path.exists(os.path.join(ck, f"ckpt_{CLI_STEPS[1]:08d}.npz")),
            "no checkpoint of the resumed run")
    out3 = cli(main, ["train", "--preset", "fusion", "--no-eval",
                      "--resume-from", os.path.join(ck, "ckpt_00000008.npz"),
                      *common, f"train.num_steps={CLI_STEPS[2]}",
                      "train.checkpoint_dir=" + ck + "_seeded"],
               log_dir, "cli_train_resume_from")
    seeded = _steps_logged(out3)
    require("seeded" in out3 and seeded == list(range(steps + 1,
                                                      CLI_STEPS[2] + 1)),
            f"--resume-from logged steps {seeded}")
    producer = _producer(np, config, train_stream, root)
    emit({"phase": "cli_train", "preset": "fusion", "steps": steps,
          "batch": cfg.train.batch_size, "windows": cfg.window.windows_per_clip,
          "hop_aware": True, "train_hops": sorted({x for h in hops for x in h}),
          "launches": counts, "s": dt, "s_per_step": step_s,
          "s_per_step_note": "median of steps 2-8, steps 3-8 under the profiler",
          "clips_per_s": clips / step_s,
          "step_s": _step_s(ck, clips),
          "producer": producer, "resumed_steps": resumed,
          "resume_from_steps": seeded})
    return ck, trace_dir


def cli_inspect_profile(main, ck, trace_dir, log_dir):
    path = os.path.join(ck, f"ckpt_{CLI_STEPS[1]:08d}.npz")
    row = json.loads(cli(main, ["inspect", "--json", path], log_dir,
                         "cli_inspect").splitlines()[-1])
    require(row["layout"].startswith("TrainState") and row["step"] == CLI_STEPS[1],
            f"inspect: {row}")
    emit({"phase": "cli_inspect", "layout": row["layout"], "step": row["step"],
          "leaves": row["leaves"], "mbytes": row["mbytes"]})
    out = cli(main, ["profile", trace_dir], log_dir, "cli_profile")
    rows = [l for l in out.splitlines() if " ms " in l]
    require(rows, "profile printed no rows")
    emit({"phase": "cli_profile", "rows": len(rows), "top": rows[:5]})


def cli_eval(np, main, root, ck, log_dir):
    """``eval --split val --per-video`` of the step-12 checkpoint, then of
    step 8 and of the ensemble of both, which must differ from each."""
    res = {}
    for name, paths in (("12", [CLI_STEPS[1]]), ("8", [8]), ("8+12", [8, CLI_STEPS[1]])):
        arg = ",".join(os.path.join(ck, f"ckpt_{s:08d}.npz") for s in paths)
        out = cli(main, ["eval", "--split", "val", "--per-video",
                         "--checkpoint", arg, "data.synthetic=false",
                         "data.root=" + root], log_dir, "cli_eval_" + name)
        rows = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
        require(len(rows) == 2 and rows[0]["video"] == "vid_v", f"eval rows {rows}")
        require(all(math.isfinite(v) for v in rows[1].values()), f"eval {rows}")
        res[name] = rows[1]
    for k in ("12", "8"):
        require(res["8+12"]["ccc_v"] != res[k]["ccc_v"],
                f"the ensemble's CCC equals checkpoint {k}'s")
    emit({"phase": "cli_eval", "split": "val",
          "ccc": {k: {m: v[m] for m in ("ccc_v", "ccc_a")} for k, v in res.items()}})


def cli_predict(main, root, ck, repo, log_dir):
    out_dir = os.path.join(repo, "build", "cli_submission")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    cli(main, ["predict", "--split", "test", "--out", out_dir, "--checkpoint",
               os.path.join(ck, f"ckpt_{CLI_STEPS[1]:08d}.npz"),
               "data.synthetic=false", "data.root=" + root], log_dir,
        "cli_predict")
    dt = time.perf_counter() - t0
    files = sorted(os.listdir(out_dir))
    vid, n, _ = ABAW_TEST
    require(files == [vid + ".txt"], f"submission files {files}")
    lines = open(os.path.join(out_dir, files[0])).read().splitlines()
    require(len(lines) == n + 1, f"{len(lines)} lines, expected {n + 1}")
    emit({"phase": "cli_predict", "split": "test", "files": files,
          "lines": len(lines), "s": dt})


def cli_export(torch, np, main, Predictor, ck, repo, log_dir):
    """``export --format torch`` of the step-12 checkpoint, the import
    script on that export, and a Predictor on each file: a 256-frame video
    predicted bit for bit alike."""
    from m3f_torch.scripts import import_torch_checkpoint
    d = os.path.join(repo, "build", "cli_export")
    os.makedirs(d, exist_ok=True)
    src = os.path.join(ck, f"ckpt_{CLI_STEPS[1]:08d}.npz")
    pt, imported = os.path.join(d, "ckpt.pt"), os.path.join(d, "imported.npz")
    cli(main, ["export", "--format", "torch", "--checkpoint", src, "--out", pt],
        log_dir, "cli_export")
    cli(import_torch_checkpoint.main, [pt, imported, "--kind", "m3f"], log_dir,
        "cli_import")
    frames, wav = synthetic_video(np, 256, 30.0, seed=7)
    p = Predictor(preset="fusion", checkpoint=src)
    want = p.predict_video(frames=frames, waveform=wav)["pred"]
    got = Predictor(preset="fusion", checkpoint=imported).predict_video(
        frames=frames, waveform=wav)["pred"]
    require(np.array_equal(got, want),
            f"imported export differs by {np.abs(got - want).max()}")
    emit({"phase": "cli_export", "format": "torch", "tensors": len(torch.load(pt)),
          "frames": len(frames), "bit_equal": True})
    del p
    return src, frames, wav, want


def cli_serve(np, repo, src, frames, wav, want, log_dir):
    """``python -m m3f_torch.main serve`` as a process of its own: /healthz
    polled, one /predict of the 256-frame video within the stream limits
    of the in-process prediction, SIGINT, exit code 0."""
    import io
    import signal
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.makedirs(log_dir, exist_ok=True)
    log = open(os.path.join(log_dir, "cli_serve.log"), "w")
    env = dict(os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "m3f_torch.main", "serve", "--preset", "fusion",
         "--checkpoint", src, "--port", str(port), "--warmup-frames", "0"],
        cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        while True:
            require(proc.poll() is None, "the server exited before serving")
            require(time.perf_counter() - t0 < 300, "the server never came up")
            try:
                json.loads(_http(base + "/healthz", timeout=5))
                break
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        pred = np.load(io.BytesIO(_http(base + "/predict",
                                        _npz(np, frames=frames, waveform=wav),
                                        {"Accept": "application/x-npy"})))
        predict_s = time.perf_counter() - t1
        diff = stream_within(np, pred, want, "served /predict")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    require(rc == 0, f"the server exited with {rc} after SIGINT")
    emit({"phase": "cli_serve", "up_s": up_s, "predict_s": predict_s,
          "frames": len(frames), **diff, "tol_max": STREAM_ATOL,
          "tol_mean": STREAM_MEAN_ATOL, "exit_code": rc})


def cli_presets(torch, np, cuda_lib, config, main, root, repo, log_dir):
    """Two steps each of ``audio_only`` (mel and GRU, no conv unit) and
    ``visual_only`` (no mel) through ``train`` on the fake tree."""
    res = {}
    for preset in ("audio_only", "visual_only"):
        cfg = config.PRESETS[preset]()
        ck = os.path.join(repo, "build", "cli_" + preset)
        shutil.rmtree(ck, ignore_errors=True)
        cuda_lib.reset_launches()
        out = cli(main, ["train", "--preset", preset, "--no-eval",
                         "data.synthetic=false", "data.root=" + root,
                         "train.num_steps=2", "train.log_every=1",
                         "train.checkpoint_every=0", "train.checkpoint_dir=" + ck],
                  log_dir, "cli_" + preset)
        torch.cuda.synchronize()
        counts = dict(cuda_lib.launches)
        conv = [k for k in counts if k.startswith("conv_")]
        if preset == "audio_only":
            ok = counts["melspec"] == 2 and counts["gru"] == 2 \
                and not any(counts[k] for k in conv)
        else:      # bf16: each bf16 unit 10 a step, no fp32 unit
            ok = counts["melspec"] == 0 \
                and counts["gru"] == 2 and all(
                    counts[k] == (0 if k.endswith("_f32") else 20)
                    for k in conv)
        require(ok, f"{preset} launches {counts}")
        require(_steps_logged(out) == [1, 2], f"{preset} steps")
        clips = cfg.train.batch_size * cfg.window.windows_per_clip
        s = _s_per_step(np, ck, clips, [2])
        res[preset] = {"batch": cfg.train.batch_size, "s_per_step": s,
                       "clips_per_s": clips / s, "launches": counts}
    emit({"phase": "cli_presets", "steps": 2, **res})


def cli_debug_nans(torch, np, config, Trainer, data):
    """A full-width fusion fit on a stream whose second batch holds a NaN
    in its wav: with ``train.debug_nans`` it raises FloatingPointError at
    step 2; without, it trains on (the second loss is NaN)."""
    base = config.apply_overrides(config.fusion(), {"train.log_every": 1})
    factory = synthetic_stream(np, base, *data, seed=3)

    def stream(skip):
        for i, b in enumerate(factory(skip)):
            if i == 1:
                b = dict(b, wav=b["wav"].copy())
                b["wav"][0, 0, 100] = np.nan
            yield b
    cfg = config.apply_overrides(base, {"train.debug_nans": True})
    t0 = time.perf_counter()
    try:
        Trainer(cfg).fit(stream, num_steps=2, log=lambda s: None)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    dt = time.perf_counter() - t0
    require(raised is not None and "step 2" in raised,
            f"debug_nans: {raised!r}, expected a FloatingPointError at step 2")
    torch.cuda.empty_cache()
    _, hist = Trainer(base).fit(stream, num_steps=2, log=lambda s: None)
    emit({"phase": "cli_debug_nans", "raised": raised.splitlines()[0][:200],
          "s": dt, "without_flag_loss": hist["loss"]})


# ---------------------------------------------------------------------------
# parallel/: the reference's checkpoint layout, world size 1 over NCCL, two
# gloo ranks on the one card
# ---------------------------------------------------------------------------

def _param_move(torch, a, b):
    return torch.cat([(a[n].float() - b[n].float()).flatten()
                      for n in a]).norm().item()


def resume_jax_layout(torch, np, cuda_lib, config, Trainer, Checkpointer,
                      data, repo):
    """Full-width fusion: 4 uninterrupted steps; 2 steps saved (the
    optimizer state in the optax chain's layout, which the JAX package's
    Checkpointer resumes), then a fresh Trainer's fit resumes the file and
    takes steps 3-4 with the launch counters set to 0 just before."""
    cfg = config.apply_overrides(config.fusion(), {"train.log_every": 1,
                                                   "train.checkpoint_every": 0})
    stream = synthetic_stream(np, cfg, *data, seed=2)
    tr = Trainer(cfg)
    state, whole = tr.fit(stream, num_steps=4, log=lambda s: None)
    p4 = {n: p.detach().clone() for n, p in state.params.items()}
    d = os.path.join(repo, "build", "resume_jax_layout")
    shutil.rmtree(d, ignore_errors=True)
    state, first = tr.fit(stream, num_steps=2, log=lambda s: None)
    p2 = {n: p.detach().clone() for n, p in state.params.items()}
    path = Checkpointer(d, cfg=cfg).save(state)
    with np.load(path) as z:
        keys = set(z.files)
        meta = json.loads(bytes(z["__meta__"]).decode())
    mu = [k for k in keys if k.startswith(".opt_state/1/0/.mu/")
          and k.endswith("/kernel")]
    require(meta["opt_layout"] == "optax" and ".opt_state/1/0/.count" in keys
            and mu and not any(k.startswith(".opt_state/mu") for k in keys),
            f"checkpoint keys not in the optax layout: {sorted(keys)[:8]}")
    del tr, state
    torch.cuda.empty_cache()
    fresh = Trainer(cfg)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    state, resumed = fresh.fit(stream, num_steps=4, log=lambda s: None,
                               checkpointer=Checkpointer(d, cfg=cfg))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    missing = [k for k in FORWARD_KERNELS if counts[k] < 2]
    missing += [k for k in BWD_KERNELS if counts[k] != 20]
    require(not missing, f"resume_jax_layout launches {counts}")
    got = {n: p.detach() for n, p in state.params.items()}
    dloss = max(abs(a - b) for a, b in zip(resumed["loss"], whole["loss"][2:]))
    rel = _param_move(torch, got, p4) / _param_move(torch, p4, p2)
    bitwise = resumed["loss"] == whole["loss"][2:] and all(
        torch.equal(got[n], p4[n]) for n in p4)
    result = {"phase": "resume_jax_layout", "preset": "fusion",
              "steps": [2, 2], "launches": counts, "s": dt,
              "loss_uninterrupted": whole["loss"],
              "loss_first_two": first["loss"],
              "loss_resumed": resumed["loss"], "max_abs_loss_diff": dloss,
              "param_diff_over_move": rel, "bitwise": bitwise,
              "optax_mu_kernel_leaves": len(mu), "tol_loss": RESUME_LOSS_ATOL,
              "tol_param": RESUME_PARAM_REL}
    require(resumed["loss"] and dloss <= RESUME_LOSS_ATOL
            and rel <= RESUME_PARAM_REL, f"resumed run: {result}")
    emit(result)


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def ddp_train(torch, np, cuda_lib, config, main, repo, log_dir):
    """``train --preset distributed_train`` (batch 32, ``mesh.num_data=-1``)
    through the CLI in this process under torchrun's variables at world
    size 1: the group must be NCCL's, every BN / loss / gradient reduction
    goes through it, rows 1-8 launch, the group is gone after."""
    import torch.distributed as dist
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    saved = {k: os.environ.get(k) for k in env}
    backends, reduces = [], [0]
    real_init, real_reduce = dist.init_process_group, dist.all_reduce

    def init(backend, **kw):
        backends.append(backend)
        return real_init(backend, **kw)

    def reduce(*a, **kw):
        reduces[0] += 1
        return real_reduce(*a, **kw)
    ck = os.path.join(repo, "build", "ddp_train")
    shutil.rmtree(ck, ignore_errors=True)
    os.environ.update(env)
    dist.init_process_group, dist.all_reduce = init, reduce
    try:
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        out = cli(main, ["train", "--preset", "distributed_train",
                         "--no-eval", "data.synthetic=true",
                         f"train.num_steps={DDP_STEPS}", "train.log_every=1",
                         "train.checkpoint_every=0",
                         "train.checkpoint_dir=" + ck], log_dir, "ddp_train")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(cuda_lib.launches)
    finally:
        dist.init_process_group, dist.all_reduce = real_init, real_reduce
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cfg = config.distributed_train()
    require(backends == ["nccl"] and "distributed: torchrun env" in out
            and not dist.is_initialized(),
            f"ddp_train: backends {backends}, group left {dist.is_initialized()}")
    require(reduces[0] > 0, "ddp_train ran no collective")
    missing = [k for k in FORWARD_KERNELS if counts[k] < DDP_STEPS]
    missing += [k for k in BWD_KERNELS if counts[k] != 10 * DDP_STEPS]
    require(not missing, f"ddp_train launches {counts}")
    require(_steps_logged(out) == list(range(1, DDP_STEPS + 1)),
            "ddp_train steps logged")
    require(os.path.exists(os.path.join(ck, f"ckpt_{DDP_STEPS:08d}.npz")),
            "ddp_train wrote no checkpoint")
    rows = [json.loads(l) for l in open(os.path.join(ck, "train.jsonl"))]
    loss = [r["loss"] for r in rows if "loss" in r]
    require(len(loss) == DDP_STEPS and all(math.isfinite(v) for v in loss),
            f"ddp_train losses {loss}")
    clips = cfg.train.batch_size * cfg.window.windows_per_clip
    step_s = _s_per_step(np, ck, clips, range(2, DDP_STEPS + 1))
    emit({"phase": "ddp_train", "preset": "distributed_train",
          "world_size": 1, "backend": backends[0],
          "batch": cfg.train.batch_size, "windows": cfg.window.windows_per_clip,
          "steps": DDP_STEPS, "launches": counts, "collectives": reduces[0],
          "s": dt, "s_per_step": step_s, "s_per_step_note":
          "median of steps 2-3, host clock (train.jsonl)",
          "clips_per_s": clips / step_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss": loss})


def ddp_steps(torch, np, cuda_lib, config, Trainer, data, view="whole",
              steps=DDP_STEPS):
    """``steps`` steps of ``distributed_train`` from the seed on the same
    global batches of 32, this process's rows of each (all of them without
    a group), with the launch counters set to 0 just before. ``view``:
    "whole" as they come; "reversed" each batch's clips in reverse order
    (the same loss and gradients, summed in another order); "half" its
    first 16 clips alone (a batch of 16); "half_twice" those 16 twice (in a
    group of two, each rank the same 16). The running means of the
    BatchNorms after step 1 come back under "_bn"."""
    import hashlib
    from m3f_torch.parallel.mesh import local_rows
    cfg = config.distributed_train()
    stream = synthetic_stream(np, cfg, *data, seed=3)(0)
    batches = [next(stream) for _ in range(steps)]
    half = cfg.train.batch_size // 2
    if view == "reversed":
        batches = [{k: np.ascontiguousarray(v[::-1]) for k, v in b.items()}
                   for b in batches]
    elif view == "half":
        batches = [{k: v[:half] for k, v in b.items()} for b in batches]
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                     batch_size=half))
    elif view == "half_twice":
        batches = [{k: np.concatenate([v[:half], v[:half]])
                    for k, v in b.items()} for b in batches]
    tr = Trainer(cfg)
    state = tr.init_state()
    keys = [k for k in ("video", "wav", "labels", "mask", "hop")
            if k in batches[0]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    loss, gnorm, ends, bn = [], [], [time.perf_counter()], {}
    for b in batches:
        m = tr.train_step(state, local_rows({k: b[k] for k in keys}, tr.mesh))
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
        ends.append(time.perf_counter())
        if not bn:
            bn = {n: t.float().cpu().numpy().copy()
                  for n, t in state.bn_state.items() if n.endswith(".mean")}
    counts = dict(cuda_lib.launches)
    h = hashlib.sha256()
    for n in sorted(state.params):
        h.update(state.params[n].detach().cpu().numpy().tobytes())
    return {"rows": len(local_rows({k: batches[0][k] for k in keys},
                                   tr.mesh)["labels"]),
            "loss": loss, "grad_norm": gnorm, "launches": counts,
            "s_per_step": (float(np.median(np.diff(ends)[1:]))
                           if steps > 1 else ends[1] - ends[0]),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params_sha256": h.hexdigest(), "_bn": bn}


@contextlib.contextmanager
def planted_fault(name):
    """``name`` of DDP_FAULTS planted in this process's port while the
    block runs: "bn_sums_unreduced" BatchNorm's sums left unreduced over the
    global count; "bn_sums_local" each rank normalising with its own rows'
    statistics; "grads_averaged" the gradients averaged over the ranks,
    not summed."""
    import m3f_torch.nn as tnn
    import m3f_torch.train.loop as tloop
    saved = tnn.all_sum, tnn.data_size, tloop.sum_grads
    if name in ("bn_sums_unreduced", "bn_sums_local"):
        tnn.all_sum = lambda *xs: xs
    if name == "bn_sums_local":
        tnn.data_size = lambda: 1
    if name == "grads_averaged":
        def averaged(grads, axis):
            saved[2](grads, axis)
            for g in grads:
                g.div_(axis.size)
        tloop.sum_grads = averaged
    try:
        yield
    finally:
        tnn.all_sum, tnn.data_size, tloop.sum_grads = saved


def ddp_eval(torch, np, config, Trainer, data):
    """Whole-video eval (the fused path) of a synthetic DDP_EVAL_FRAMES
    frame video and the sequence forward of DDP_EVAL_SEQS sequences (a
    count two ranks do not divide) through ``make_sharded_eval_forward``,
    with ``distributed_train``'s seeded init: in a group, each rank runs its
    share of the sequences and gathers the rest."""
    from m3f_torch.parallel.seqpar import make_sharded_eval_forward
    cfg = config.distributed_train()
    tr = Trainer(cfg)
    state = tr.init_state()
    frames, wav = synthetic_video(np, DDP_EVAL_FRAMES, 30.0, seed=21)
    ev = tr.evaluate_video(state, _video_dict(np, frames, wav, seed=21))
    b = next(synthetic_stream(np, cfg, *data, seed=3)(0))
    feed = {k: b[k][:DDP_EVAL_SEQS] for k in ("video", "wav")}
    seq = make_sharded_eval_forward(tr.mesh, tr.make_eval_forward())(feed)
    return {"pred": ev["pred"], "ccc": [ev["ccc_v"], ev["ccc_a"]],
            "seq": seq.float().cpu().numpy()}


def _bn_gaps(np, got, want):
    """Each running mean's max |got - want| over its largest |want|
    (reported: a mean near 0 makes it large for a rounding)."""
    require(got.keys() == want.keys(), "BatchNorm buffers differ")
    return {n: float(np.abs(got[n] - want[n]).max()
                     / max(float(np.abs(want[n]).max()), 1e-30)) for n in want}


def _bn_rel(np, got, want):
    return max(_bn_gaps(np, got, want).values(), default=0.0)


def batch_invariance(torch, np, config, Trainer, data):
    """The eval forward (seeded init, running statistics: nothing mixes
    the batch) of the first 16 sequences of ``distributed_train``'s first
    batch, run in the batch of 32 and alone → the largest difference: how
    far a sequence's numbers on the card depend on the batch around it."""
    cfg = config.distributed_train()
    tr = Trainer(cfg)
    b = next(synthetic_stream(np, cfg, *data, seed=3)(0))
    feed = {k: b[k] for k in ("video", "wav")}
    half = cfg.train.batch_size // 2
    fwd = tr.make_eval_forward()
    with torch.no_grad():
        whole = fwd(feed)[:half].float().cpu().numpy()
        alone = fwd({k: v[:half] for k, v in feed.items()}).float().cpu().numpy()
    return float(np.abs(whole - alone).max())


def ddp_two_ranks(torch, np, cuda_lib, config, Trainer, data, repo):
    """The same steps in this process without a group (world size 1), then
    this script twice more as two gloo ranks on the one card (16 of the 32
    clips each): the ranks bit-equal, each against world size 1, every
    BatchNorm reduced. Beside it, world size 1 on the same batches with
    their clips reversed against world size 1: how far another summation
    order alone moves the same numbers (reported, no limit); the witness,
    both ranks on the same 16 clips against one process on those 16, and
    ``batch_invariance`` (reported, no limit); each
    planted fault against world size 1, which must break a limit; sharded
    eval against one process."""
    one = ddp_steps(torch, np, cuda_lib, config, Trainer, data)
    bn_one = one.pop("_bn")
    torch.cuda.empty_cache()
    noise = ddp_steps(torch, np, cuda_lib, config, Trainer, data,
                      view="reversed")
    bn_noise = noise.pop("_bn")
    torch.cuda.empty_cache()
    half = ddp_steps(torch, np, cuda_lib, config, Trainer, data, view="half")
    half.pop("_bn")
    torch.cuda.empty_cache()
    ev_one = ddp_eval(torch, np, config, Trainer, data)
    torch.cuda.empty_cache()
    invariance = batch_invariance(torch, np, config, Trainer, data)
    torch.cuda.empty_cache()
    out = os.path.join(repo, "build", "ddp_two_ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r),
         port, out], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=600)[0])
    finally:
        for pr in procs:
            pr.kill()
    dt = time.perf_counter() - t0
    for r, (pr, log) in enumerate(zip(procs, logs)):
        require(pr.returncode == 0, f"ddp rank {r} exit {pr.returncode}: "
                f"{log[-3000:]}")
    runs = [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(2)]
    bns = []
    for r in range(2):
        flat = np.load(os.path.join(out, f"rank{r}_bn.npz"))
        bns.append({})
        for k in flat.files:
            view, name = k.split("/", 1)
            bns[r].setdefault(view, {})[name] = flat[k]
    a, b = runs[0]["whole"], runs[1]["whole"]
    require(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
            and a["params_sha256"] == b["params_sha256"],
            f"the two ranks differ: {a} {b}")
    require(runs[0]["backend"] == "gloo" and runs[0]["world_size"] == 2
            and a["rows"] == 16,
            f"rank 0: {runs[0]['backend']} {runs[0]['world_size']} {a}")
    for rk in (a, b):
        missing = [k for k in FORWARD_KERNELS if rk["launches"][k] < DDP_STEPS]
        missing += [k for k in BWD_KERNELS
                    if rk["launches"][k] != 10 * DDP_STEPS]
        require(not missing, f"ddp rank launches {rk['launches']}")

    def gaps(run, ref):
        return (abs(run["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
                abs(run["grad_norm"][0] - ref["grad_norm"][0])
                / ref["grad_norm"][0],
                max((abs(x - y) for x, y in zip(run["loss"][1:],
                                                ref["loss"][1:])), default=0.0))

    def within(g):
        return (g[0] <= DDP_LOSS_RTOL and g[1] <= DDP_GNORM_RTOL
                and g[2] <= DDP_LATER_LOSS_ATOL)

    def bn_ranks_equal(view):
        a0, a1 = bns[0][view], bns[1][view]
        return a0.keys() == a1.keys() and all(np.array_equal(a0[k], a1[k])
                                              for k in a0)

    d = gaps(a, one)
    n = gaps(noise, one)
    w = gaps(runs[0]["half_twice"], half)
    faults = {}
    for f in DDP_FAULTS:
        g = gaps(runs[0][f], one)
        faults[f] = {"loss": runs[0][f]["loss"],
                     "grad_norm": runs[0][f]["grad_norm"],
                     "first_loss_rel_diff": g[0],
                     "first_grad_norm_rel_diff": g[1],
                     "bn_mean_rel_diff": _bn_rel(np, bns[0][f], bn_one),
                     "bn_ranks_equal": bn_ranks_equal(f),
                     "refused": not (within(g) and bn_ranks_equal(f))}
    ev = [{k: np.asarray(v) for k, v in r["eval"].items()} for r in runs]
    require(all(e[k].shape == ev_one[k].shape for e in ev
                for k in ("pred", "seq")), "sharded eval shapes")
    ev_gap = max(float(np.abs(ev[0][k] - ev_one[k]).max())
                 for k in ("pred", "seq"))
    # the stitch adds by index_add_, whose atomics land in any order
    ev_ranks = float(np.abs(ev[0]["pred"] - ev[1]["pred"]).max())
    result = {"phase": "ddp_two_ranks", "preset": "distributed_train",
              "world_size": 2, "backend": "gloo", "rows_per_rank": a["rows"],
              "steps": DDP_STEPS, "s": dt, "ranks": [a, b],
              "world_size_1": one,
              "first_loss_rel_diff": d[0], "first_grad_norm_rel_diff": d[1],
              "later_loss_max_abs_diff": d[2],
              "bn_ranks_equal": bn_ranks_equal("whole"),
              "bn_mean_rel_diff": _bn_rel(np, bns[0]["whole"], bn_one),
              "bn_mean_rel_diff_largest": sorted(
                  _bn_gaps(np, bns[0]["whole"], bn_one).items(),
                  key=lambda kv: -kv[1])[:4],
              "batch_invariance_max_abs_diff": invariance,
              "reversed_world_size_1": {
                  "loss": noise["loss"], "grad_norm": noise["grad_norm"],
                  "first_loss_rel_diff": n[0],
                  "first_grad_norm_rel_diff": n[1],
                  "later_loss_max_abs_diff": n[2],
                  "bn_mean_rel_diff": _bn_rel(np, bn_noise, bn_one)},
              "witness_same_16_clips": {
                  "world_size_1": {"loss": half["loss"],
                                   "grad_norm": half["grad_norm"]},
                  "ranks": {"loss": runs[0]["half_twice"]["loss"],
                            "grad_norm": runs[0]["half_twice"]["grad_norm"]},
                  "first_loss_rel_diff": w[0],
                  "first_grad_norm_rel_diff": w[1],
                  "later_loss_max_abs_diff": w[2]},
              "planted_faults": faults,
              "eval": {"frames": DDP_EVAL_FRAMES, "seqs": DDP_EVAL_SEQS,
                       "max_abs_diff": ev_gap,
                       "ranks_max_abs_diff": ev_ranks,
                       "ranks_seq_equal": bool(np.array_equal(
                           ev[0]["seq"], ev[1]["seq"])),
                       "ccc_ranks": ev[0]["ccc"].tolist(), "ccc_world_size_1":
                           [float(x) for x in ev_one["ccc"]],
                       "pred_spread": float(np.ptp(ev_one["pred"]))},
              "tol_loss": DDP_LOSS_RTOL,
              "tol_grad_norm": DDP_GNORM_RTOL,
              "tol_later_loss": DDP_LATER_LOSS_ATOL,
              "tol_eval": DDP_EVAL_ATOL}
    require(within(d) and result["bn_ranks_equal"],
            f"two ranks against world size 1: {result}")
    require(w[0] <= DDP_WITNESS_LOSS_RTOL and w[1] <= DDP_WITNESS_GNORM_RTOL
            and w[2] <= DDP_WITNESS_LATER_ATOL,
            f"the same 16 clips on two ranks against one process: {result}")
    require(all(f["refused"] for f in faults.values()),
            f"a planted fault within the limits: {faults}")
    require(result["eval"]["ranks_seq_equal"] and ev_gap <= DDP_EVAL_ATOL
            and ev_ranks <= DDP_EVAL_ATOL, f"sharded eval: {result}")
    emit(result)


def ddp_rank(rank, port, out):
    """One gloo rank of ``ddp_two_ranks`` (``chip_smoke.py --ddp-rank R
    PORT OUT``): joins the group through the port's launcher, runs
    ``ddp_steps`` on its rows ("whole"), on the same 16 clips as the other
    rank ("half_twice") and, one step each, with each of DDP_FAULTS
    planted, then ``ddp_eval``; writes ``OUT/rankR.json`` and the running
    means ``OUT/rankR_bn.npz``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from m3f_torch import config
    from m3f_torch.data.synthetic import SyntheticAVDataset
    from m3f_torch.data.windowing import WindowSequencer, example_stream
    from m3f_torch.ops import cuda_lib
    from m3f_torch.parallel.mesh import maybe_initialize_distributed
    from m3f_torch.train.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = (SyntheticAVDataset, WindowSequencer, example_stream)
    plan = maybe_initialize_distributed(
        {"M3F_COORDINATOR": f"127.0.0.1:{port},2,{rank}"}, device="cuda",
        backend="gloo")
    res, bn = {}, {}
    try:
        for view in ("whole", "half_twice"):
            res[view] = ddp_steps(torch, np, cuda_lib, config, Trainer, data,
                                  view=view)
            torch.cuda.empty_cache()
        for f in DDP_FAULTS:
            with planted_fault(f):
                res[f] = ddp_steps(torch, np, cuda_lib, config, Trainer, data,
                                   steps=1)
            torch.cuda.empty_cache()
        for k in res:
            bn.update({f"{k}/{n}": v for n, v in res[k].pop("_bn").items()})
        ev = ddp_eval(torch, np, config, Trainer, data)
        res["eval"] = {"pred": ev["pred"].tolist(), "seq": ev["seq"].tolist(),
                       "ccc": [float(x) for x in ev["ccc"]]}
        res.update(backend=dist.get_backend(), world_size=dist.get_world_size(),
                   rank=dist.get_rank(), plan=plan.reason)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(out, f"rank{rank}_bn.npz"), **bn)
    return 0


# ---------------------------------------------------------------------------
# parallel/, the model axis: four gloo ranks on the one card as a 2 x 2 mesh
# ---------------------------------------------------------------------------

TP_MESH = (2, 2)         # tp_ranks: data rows x model ranks (four gloo ranks)
TP_CLIPS = 4             # clips a data row (a global batch of 8)
TP_STEPS = 3             # train steps of distributed_train
TP_CKPT_STEP = 2         # the ranks write a checkpoint after this step
TP_LOSS_RTOL = 1e-4      # against world size 1 on the same global batches:
#                          the first step's loss ...
TP_GNORM_RTOL = DDP_GNORM_RTOL   # ... its gradient norm ...
TP_LATER_LOSS_ATOL = DDP_LATER_LOSS_ATOL   # ... and the later losses
# faults planted in the rank processes (``tp_planted_fault``); in one step
# each must break a limit above against world size 1 or leave the ranks
# disagreeing on a replicated value (the loss or the gradient norm)
TP_FAULTS = ("tp_gather_grad_summed", "tp_head_unreduced", "tp_norm_local")
TP_SEQ = (16, 128, 768, 256)   # sequence-parallel BiGRU: B, T a rank, D, H
TP_SEQ_ATOL = GRU_ATOL_BF16    # its bf16 output against the unsharded layer
TP_SEQ_GRAD_REL = 2e-2   # its gradients, to each leaf's largest element


def tp_cfg(config, num_data, num_model):
    """``distributed_train`` at TP_CLIPS clips a data row of a
    ``num_data`` x ``num_model`` mesh; world size 1 takes the whole global
    batch of the 2 x 2 mesh."""
    cfg = config.distributed_train()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=TP_CLIPS * TP_MESH[0],
        mesh=dataclasses.replace(cfg.train.mesh, num_data=num_data,
                                 num_model=num_model)))


def _digests(tensors, tp=None):
    """sha256 of each tensor's bytes (whole under ``tp``: the blocks
    gathered, a collective)."""
    import hashlib
    out = {}
    for n, t in tensors.items():
        t = t.detach() if tp is None else tp.full(n, t.detach())
        out[n] = hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()
    return out


def _state_digests(state, whole):
    """Digests of every leaf of a state: params, BN buffers, EMA, Adam's
    moments; this rank's blocks, or (``whole``) the sharded ones gathered."""
    tp = state.tp if whole else None
    inner = state.opt_state.get("inner", state.opt_state)
    groups = {"params": state.params, "bn_state": state.bn_state,
              "ema": state.ema or {}, "mu": inner.get("mu", {}),
              "nu": inner.get("nu", {})}
    return {f"{g}/{n}": d for g, ts in groups.items()
            for n, d in _digests(ts, tp).items()}


def tp_steps(torch, np, cuda_lib, config, Checkpointer, Trainer, data,
             mesh=(1, 1), steps=TP_STEPS, ckpt=None):
    """``steps`` steps of ``tp_cfg`` on a ``mesh`` from the seed on the same
    global batches, this process's rows of each, the launch counters set
    to 0 just before; with ``ckpt`` a checkpoint written there after step
    TP_CKPT_STEP (not timed). Each step's time on the host clock (after the
    step's metrics are read), the leaves' digests (this rank's blocks)
    after the last step, and at the checkpoint the whole leaves'."""
    from m3f_torch.parallel.mesh import local_rows
    cfg = tp_cfg(config, *mesh)
    stream = synthetic_stream(np, cfg, *data, seed=3)(0)
    batches = [next(stream) for _ in range(steps)]
    tr = Trainer(cfg)
    state = tr.init_state()
    keys = [k for k in ("video", "wav", "labels", "mask", "hop")
            if k in batches[0]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    loss, gnorm, step_s, at_ckpt = [], [], [], None
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        m = tr.train_step(state, local_rows({k: b[k] for k in keys}, tr.mesh))
        loss.append(float(m["loss"]))
        gnorm.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
        if ckpt is not None and i + 1 == TP_CKPT_STEP:
            Checkpointer(ckpt, cfg=cfg).save(state)
            at_ckpt = _state_digests(state, whole=True)
    counts = dict(cuda_lib.launches)
    return {"rows": len(local_rows({k: batches[0][k] for k in keys},
                                   tr.mesh)["labels"]),
            "mesh": [tr.mesh.size, tr.mesh.model.size],
            "sharded": sorted(tr.tp.dims) if tr.tp is not None else [],
            "loss": loss, "grad_norm": gnorm, "launches": counts,
            "step_s": step_s, "peak_mem_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "digests": _state_digests(state, whole=False),
            "ckpt_digests": at_ckpt}


@contextlib.contextmanager
def tp_planted_fault(name):
    """``name`` of TP_FAULTS planted in this process's port while the block
    runs: "tp_gather_grad_summed" the BiGRU's gathers sum the gradient over
    the model axis before taking their block (what a reduce-scatter
    does: every sharded gradient, and through the layer's input every
    earlier one, doubled); "tp_head_unreduced" the fusion head's partial
    products left unsummed; "tp_norm_local" the gradient norm of the clip
    and of ``grad_norm`` without the other model rank's blocks."""
    import m3f_torch.models.m3f as tm3f
    import m3f_torch.parallel.mesh as tmesh
    import m3f_torch.train.optim as toptim
    saved = (tmesh._GatherBlocks.backward, tm3f.model_sum, toptim.axis_sum)

    def summed(ctx, g):
        g = tmesh._flat_all_reduce([g.contiguous()], ctx.axis.group)[0]
        return tmesh.own_block(g, ctx.axis, ctx.dim), None, None
    if name == "tp_gather_grad_summed":
        tmesh._GatherBlocks.backward = staticmethod(summed)
    if name == "tp_head_unreduced":
        tm3f.model_sum = lambda x, axis: x
    if name == "tp_norm_local":
        toptim.axis_sum = lambda x, axis: x
    try:
        yield
    finally:
        tmesh._GatherBlocks.backward = staticmethod(saved[0])
        tm3f.model_sum, toptim.axis_sum = saved[1], saved[2]


def tp_seqpar(torch, cuda_lib, axis):
    """The sequence-parallel BiGRU (``bigru_seq_parallel``) at full width,
    bf16, over the data axis ``axis``: a sequence of TP_SEQ's T steps a
    rank, this rank's chunk, against the unsharded layer on the whole
    sequence in this process: the output chunk and the input's chunk of
    the gradient (bit-equal flags and the largest differences) and every
    weight's gradient (summed over the ranks); device-synchronised host
    times of the forward (the second of two calls) and of the gradient
    run, each beside the unsharded layer's; the ``gru`` launches of the
    gradient run."""
    from m3f_torch.models.gru import BiGRU
    from m3f_torch.parallel.seqpar import bigru_seq_parallel
    B, T, D, H = TP_SEQ
    m = BiGRU(D, H, torch.Generator().manual_seed(31)).cuda()
    g = torch.Generator(device="cuda").manual_seed(32)
    n = T * axis.size
    x = (torch.randn(B, n, D, device="cuda", generator=g) * 0.5).bfloat16()
    cot = torch.randn(B, n, 2 * H, device="cuda", generator=g)
    rows = slice(axis.rank * T, (axis.rank + 1) * T)
    params = list(m.parameters())

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    with torch.no_grad():
        for _ in range(2):
            y, fwd_s = clock(lambda: bigru_seq_parallel(
                m, x[:, rows].contiguous(), axis))
            yw, whole_fwd_s = clock(lambda: m(x))
    xc = x[:, rows].contiguous().requires_grad_()
    cuda_lib.reset_launches()

    def sharded_grads():
        out = bigru_seq_parallel(m, xc, axis)
        return torch.autograd.grad((out.float() * cot[:, rows]).sum(),
                                   [xc] + params)
    gs, grad_s = clock(sharded_grads)
    launches = {k: cuda_lib.launches[k] for k in ("gru", "gru_stream")}
    xw = x.clone().requires_grad_()
    gw, whole_grad_s = clock(lambda: torch.autograd.grad(
        (m(xw).float() * cot).sum(), [xw] + params))
    want = yw[:, rows]
    rel = {n_: ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()
           for n_, a, b in zip(["x"] + [p for p, _ in m.named_parameters()],
                               [gs[0]] + list(gs[1:]),
                               [gw[0][:, rows]] + list(gw[1:]))}
    return {"shape_b_t_rank_d_h": list(TP_SEQ), "ranks": axis.size,
            "out_bit_equal": torch.equal(y, want),
            "out_max_abs_diff": (y.float() - want.float()).abs().max().item(),
            "dx_bit_equal": torch.equal(gs[0], gw[0][:, rows]),
            "grad_rel_diff": rel, "launches": launches,
            "fwd_s": fwd_s, "unsharded_fwd_s": whole_fwd_s,
            "grad_s": grad_s, "unsharded_grad_s": whole_grad_s}


def tp_ranks(torch, np, cuda_lib, config, Checkpointer, Trainer, data, repo):
    """The steps at world size 1 in this process, then this script four
    more times as gloo ranks on the one card (``--tp-rank``): a 2 x 2 mesh
    of distributed_train, TP_CLIPS clips a data row, against world size 1
    on the same global batches (first loss, first gradient norm, later
    losses); the replicated leaves bit-equal on all four ranks and the
    blocks within each column; the ranks' checkpoint resumed at world size
    1 holding every array the ranks held (gathered), bit for bit, and its
    next step within the later-loss limit of the ranks'; each planted fault
    refused; the sequence-parallel BiGRU held on every rank."""
    from m3f_torch.parallel.mesh import local_rows
    out = os.path.join(repo, "build", "tp_ranks")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    one = tp_steps(torch, np, cuda_lib, config, Checkpointer, Trainer, data)
    torch.cuda.empty_cache()
    port = str(_free_port())
    n = TP_MESH[0] * TP_MESH[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         port, out], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=600)[0])
    finally:
        for pr in procs:
            pr.kill()
    dt = time.perf_counter() - t0
    for r, (pr, log) in enumerate(zip(procs, logs)):
        require(pr.returncode == 0, f"tp rank {r} exit {pr.returncode}: "
                f"{log[-3000:]}")
    runs = [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(n)]
    whole = [r["whole"] for r in runs]
    require(all(r["backend"] == "gloo" and r["world_size"] == n
                for r in runs) and whole[0]["mesh"] == list(TP_MESH)
            and whole[0]["rows"] == TP_CLIPS and whole[0]["sharded"],
            f"tp ranks: {[(r['backend'], r['world_size']) for r in runs]} "
            f"{whole[0]['mesh']} {whole[0]['rows']} {whole[0]['sharded']}")
    sharded = set(whole[0]["sharded"])
    col = {r: [q for q in range(n) if q % TP_MESH[1] == r % TP_MESH[1]]
           for r in range(n)}
    unequal = sorted({k for r in range(n) for k, d in whole[r]["digests"].items()
                      if any(whole[q]["digests"][k] != d for q in
                             (col[r] if k.split("/", 1)[1] in sharded
                              else range(n)))})
    same_metrics = all(w["loss"] == whole[0]["loss"]
                       and w["grad_norm"] == whole[0]["grad_norm"]
                       for w in whole)
    for rk in whole:
        missing = [k for k in FORWARD_KERNELS if rk["launches"][k] < TP_STEPS]
        missing += [k for k in BWD_KERNELS
                    if rk["launches"][k] != 10 * TP_STEPS]
        require(not missing, f"tp rank launches {rk['launches']}")

    def gaps(run, ref):
        return (abs(run["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]),
                abs(run["grad_norm"][0] - ref["grad_norm"][0])
                / ref["grad_norm"][0],
                max((abs(x - y) for x, y in zip(run["loss"][1:],
                                                ref["loss"][1:])), default=0.0))

    def within(g):
        return (g[0] <= TP_LOSS_RTOL and g[1] <= TP_GNORM_RTOL
                and g[2] <= TP_LATER_LOSS_ATOL)
    d = gaps(whole[0], one)
    faults = {}
    for f in TP_FAULTS:
        g = gaps(runs[0][f], one)
        agree = all(r[f]["loss"] == runs[0][f]["loss"]
                    and r[f]["grad_norm"] == runs[0][f]["grad_norm"]
                    for r in runs)
        faults[f] = {"loss": [r[f]["loss"][0] for r in runs],
                     "grad_norm": [r[f]["grad_norm"][0] for r in runs],
                     "first_loss_rel_diff": g[0],
                     "first_grad_norm_rel_diff": g[1],
                     "ranks_agree": agree,
                     "refused": not (within(g) and agree)}
    # the ranks' checkpoint at world size 1: every array the ranks held,
    # then its next step
    cfg1 = tp_cfg(config, 1, 1)
    tr = Trainer(cfg1)
    state = Checkpointer(os.path.join(out, "ck"), cfg=cfg1).maybe_restore(
        tr.init_state(), tr)
    resumed = _state_digests(state, whole=False)
    ck_unequal = sorted(k for k, v in whole[0]["ckpt_digests"].items()
                        if resumed.get(k) != v)
    stream = synthetic_stream(np, cfg1, *data, seed=3)(0)
    batch = [next(stream) for _ in range(TP_STEPS)][TP_CKPT_STEP]
    keys = [k for k in ("video", "wav", "labels", "mask", "hop") if k in batch]
    next_loss = float(tr.train_step(state, local_rows(
        {k: batch[k] for k in keys}, tr.mesh))["loss"])
    resume_gap = abs(next_loss - whole[0]["loss"][TP_CKPT_STEP])
    del tr, state
    torch.cuda.empty_cache()
    seq = [r["seqpar"] for r in runs]
    seq_err = max(s["out_max_abs_diff"] for s in seq)
    seq_grad = max(v for s in seq for v in s["grad_rel_diff"].values())
    result = {"phase": "tp_ranks", "preset": "distributed_train",
              "mesh": list(TP_MESH), "world_size": n, "backend": "gloo",
              "rows_per_data_row": TP_CLIPS, "steps": TP_STEPS, "s": dt,
              "sharded": sorted(sharded),
              "step_s_per_rank": [w["step_s"] for w in whole],
              "peak_mem_gb_per_rank": [w["peak_mem_gb"] for w in whole],
              "launches_rank0": whole[0]["launches"],
              "loss": whole[0]["loss"], "grad_norm": whole[0]["grad_norm"],
              "world_size_1": {k: one[k] for k in ("loss", "grad_norm",
                                                   "step_s", "peak_mem_gb")},
              "first_loss_rel_diff": d[0], "first_grad_norm_rel_diff": d[1],
              "later_loss_max_abs_diff": d[2],
              "ranks_metrics_equal": same_metrics,
              "leaves_unequal": unequal,
              "checkpoint": {"step": TP_CKPT_STEP,
                             "arrays": len(whole[0]["ckpt_digests"]),
                             "unequal_at_world_size_1": ck_unequal,
                             "next_loss": next_loss,
                             "ranks_next_loss":
                                 whole[0]["loss"][TP_CKPT_STEP],
                             "next_loss_abs_diff": resume_gap},
              "planted_faults": faults,
              "seqpar": {"per_rank": seq, "max_abs_diff": seq_err,
                         "grad_rel_diff_max": seq_grad,
                         "tol": TP_SEQ_ATOL, "tol_grad_rel": TP_SEQ_GRAD_REL},
              "tol_loss": TP_LOSS_RTOL, "tol_grad_norm": TP_GNORM_RTOL,
              "tol_later_loss": TP_LATER_LOSS_ATOL}
    emit(result)
    require(within(d) and same_metrics and not unequal,
            "2 x 2 ranks against world size 1, or the ranks' leaves")
    require(not ck_unequal and resume_gap <= TP_LATER_LOSS_ATOL,
            "the 2 x 2 checkpoint at world size 1")
    require(all(f["refused"] for f in faults.values()),
            f"a planted fault within the limits: {faults}")
    require(all(s["launches"]["gru"] == 2 and s["launches"]["gru_stream"] == 0
                for s in seq) and seq_err <= TP_SEQ_ATOL
            and seq_grad <= TP_SEQ_GRAD_REL,
            "the sequence-parallel BiGRU against the unsharded layer")


def tp_rank(rank, port, out):
    """One gloo rank of ``tp_ranks`` (``chip_smoke.py --tp-rank R PORT
    OUT``): joins the group of four through the port's launcher, runs
    ``tp_steps`` on the 2 x 2 mesh (writing the checkpoint into
    ``OUT/ck``), one step under each of TP_FAULTS, then ``tp_seqpar`` over
    its data axis; writes ``OUT/rankR.json``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from m3f_torch import config
    from m3f_torch.data.synthetic import SyntheticAVDataset
    from m3f_torch.data.windowing import WindowSequencer, example_stream
    from m3f_torch.ops import cuda_lib
    from m3f_torch.parallel.mesh import create_mesh, maybe_initialize_distributed
    from m3f_torch.train.checkpoint import Checkpointer
    from m3f_torch.train.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = (SyntheticAVDataset, WindowSequencer, example_stream)
    n = TP_MESH[0] * TP_MESH[1]
    plan = maybe_initialize_distributed(
        {"M3F_COORDINATOR": f"127.0.0.1:{port},{n},{rank}"}, device="cuda",
        backend="gloo")
    res = {}
    try:
        res["whole"] = tp_steps(torch, np, cuda_lib, config, Checkpointer,
                                Trainer, data, mesh=TP_MESH,
                                ckpt=os.path.join(out, "ck"))
        torch.cuda.empty_cache()
        for f in TP_FAULTS:
            with tp_planted_fault(f):
                res[f] = tp_steps(torch, np, cuda_lib, config, Checkpointer,
                                  Trainer, data, mesh=TP_MESH, steps=1)
            torch.cuda.empty_cache()
        res["seqpar"] = tp_seqpar(torch, cuda_lib,
                                  create_mesh(*TP_MESH).data)
        res.update(backend=dist.get_backend(), world_size=dist.get_world_size(),
                   rank=dist.get_rank(), plan=plan.reason)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def main():
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from m3f_torch import config
        from m3f_torch.ops import conv_bn, cuda_lib, gru, melspec
        from m3f_torch.ops import packed_conv as pc
        from m3f_torch.scripts import probe_packed_conv as probe
        from m3f_torch.config import MelConfig
        from m3f_torch.data.synthetic import SyntheticAVDataset
        from m3f_torch.data.windowing import WindowSequencer, example_stream
        from m3f_torch.infer import Predictor, PredictServer, SessionGroup
        from m3f_torch.infer.submission import write_submission
        from m3f_torch.train.checkpoint import (Checkpointer, save_pytree,
                                                to_jax_params)
        from m3f_torch.train.loop import Trainer
        from m3f_torch.utils import profiling
        from m3f_torch import main as cli_main
        from m3f_torch.data import native_loader
    except ImportError as e:
        print(f"chip_smoke: the m3f_torch package is not next to this file "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_lib.build()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0})

    # 2. each kernel against its plain version at the main path's shapes
    mel400 = {"n_fft": 400, "win_length": 400}     # not a power of two
    kernels = [check_mel(torch, cuda_lib, melspec, MelConfig(), "melspec"),
               check_mel(torch, cuda_lib, melspec, MelConfig(**mel400),
                         "melspec_n_fft_400"),
               *check_gru(torch, cuda_lib, gru)]
    check_mel_sizes(torch, cuda_lib, melspec, MelConfig)
    kernels += check_conv(torch, F, conv_bn)
    check_edges(torch, F, cuda_lib, melspec, gru, conv_bn, MelConfig())
    torch.cuda.empty_cache()
    kernels += check_conv_f32(torch, F, conv_bn)
    torch.cuda.empty_cache()
    check_lane(torch, F, conv_bn)
    torch.cuda.empty_cache()
    kernels += check_bwd(torch, F, conv_bn)
    check_bwd_edges(torch, conv_bn)
    torch.cuda.empty_cache()
    kernels += check_conv_f32_bwd(torch, F, conv_bn)
    torch.cuda.empty_cache()

    # 2b. the probe slice: its kernels against their plain versions, then
    # the probe itself at full shape (its own launch counts)
    probe_kernels, counts_probe = check_probe(torch, F, cuda_lib, pc, probe)
    kernels += probe_kernels

    # 3. the serving path at full width
    p = Predictor(preset="longseq_eval")
    frames, wav = synthetic_video(np, 1024, 30.0, seed=0)
    torch.cuda.reset_peak_memory_stats()
    p.predict_video(frames=frames, waveform=wav)          # warm run
    pred30, counts30, dt = serve(torch, np, cuda_lib, p, frames, wav)
    want = {k: 0 for k in cuda_lib.launches}
    want.update({"melspec": 1, "gru": p.cfg.model.gru.num_layers,
                 "conv_spatial": 10, "conv_temporal": 10})
    require(counts30 == want, f"launches {counts30}, expected {want}")
    emit({"phase": "serve_30fps", "frames": 1024, "launches": counts30,
          "s": dt, "frames_per_s": 1024 / dt,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    frames25, wav25 = synthetic_video(np, 1024, 25.0, seed=1)
    pred25, counts25, dt25 = serve(torch, np, cuda_lib, p, frames25, wav25,
                                   fps=25.0)
    emit({"phase": "serve_25fps", "frames": 1024, "launches": counts25,
          "s": dt25, "frames_per_s": 1024 / dt25})
    pc = Predictor(preset="longseq_eval",
                   overrides={"window.eval_max_windows": 64})
    pc.model.load_state_dict(p.model.state_dict())
    pred_c, counts_c, dtc = serve(torch, np, cuda_lib, pc, frames, wav)
    diff_c = float(np.abs(pred_c - pred30).max())
    require(diff_c <= CHUNK_ATOL, f"chunked vs fused eval differ by {diff_c}")
    emit({"phase": "serve_chunked", "frames": 1024, "launches": counts_c,
          "s": dtc, "frames_per_s": 1024 / dtc,
          "max_abs_diff_vs_fused": diff_c, "tol": CHUNK_ATOL})
    serve_many(torch, np, p)

    # 3b. live serving: warmup, streams, a session group, the HTTP server,
    # and a trace of one served video
    t0 = time.perf_counter()
    p.warmup(max_frames=1024, rates=(25.0,))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    SessionGroup(p, max_batch=16).warmup(rates=(25.0,))
    emit({"phase": "warmup", "max_frames": 1024, "rates": [25.0],
          "predictor_s": warm_s, "group_s": time.perf_counter() - t0})
    serve_stream(torch, np, cuda_lib, p, frames, wav, pred30)
    serve_stream(torch, np, cuda_lib, p, frames25, wav25, pred25, fps=25.0,
                 phase="serve_stream_25fps")
    videos, offline = session_group(torch, np, cuda_lib, SessionGroup, p)
    http_server(torch, np, PredictServer, p, frames, wav, pred30, videos,
                offline)
    trace_serve(torch, np, profiling, p, frames, wav,
                os.path.join(repo, "build", "trace_serve"))
    # the same weights with a mel n_fft of 400: the same mel kernel, on
    # mixed-radix stages
    p400 = Predictor(preset="longseq_eval", overrides={
        f"model.mel.{k}": v for k, v in mel400.items()})
    p400.model.load_state_dict(p.model.state_dict())
    p400.predict_video(frames=frames, waveform=wav)       # warm run
    _, counts400, dt400 = serve(torch, np, cuda_lib, p400, frames, wav)
    require(counts400 == want, f"launches {counts400}, expected {want}")
    emit({"phase": "serve_mel_n_fft_400", "frames": 1024,
          "launches": counts400, "s": dt400, "frames_per_s": 1024 / dt400})
    cfg_serve = p.cfg
    del p, pc, p400
    torch.cuda.empty_cache()

    # 3c. checkpoint ensembles: two members of the same preset, a served
    # video, then three videos scored and written as a submission
    tr_e, a, b = serve_ensemble(torch, np, cuda_lib, Trainer, cfg_serve,
                                frames, wav, want)
    eval_ensemble(torch, np, write_submission, tr_e, a, b,
                  os.path.join(repo, "build", "submission"))
    del tr_e, a, b
    torch.cuda.empty_cache()

    # 3d. every visual backbone of the reference served at full width (five
    # bf16 variants and fp32 activations), each beside its CPU run
    counts_f32 = serve_backbones(torch, np, cuda_lib, Predictor, frames, wav)

    # 4. whole-path parity: one narrow model, CPU plain versions vs kernels
    overrides = {"model.visual.block_channels": [32, 64, 128, 256],
                 "model.visual.stem_channels": 32,
                 "model.visual.feature_dim": 256,
                 "model.audio.channels": [8, 16, 32, 64],
                 "model.audio.feature_dim": 64,
                 "model.gru.hidden_size": 64,
                 "window.windows_per_clip": 2,
                 "data.image_size": 32}
    p_cpu = Predictor(preset="longseq_eval", overrides=overrides, device="cpu")
    p_gpu = Predictor(preset="longseq_eval", overrides=overrides)
    p_gpu.model.load_state_dict(p_cpu.model.state_dict())
    rng = np.random.RandomState(4)
    results = {}
    for fps, n in ((None, 96), (25.0, 80)):
        f = rng.randint(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        w = (rng.randn(int(round(n / (fps or 30.0) * 16000)) + 16000) * 0.1
             ).astype(np.float32)
        a = p_cpu.predict_video(frames=f, waveform=w, fps=fps)["pred"]
        cuda_lib.reset_launches()
        b = p_gpu.predict_video(frames=f, waveform=w, fps=fps)["pred"]
        require(all(cuda_lib.launches[k] for k in FORWARD_KERNELS),
                f"narrow card run skipped a kernel: {cuda_lib.launches}")
        d = np.abs(a - b)
        require(d.max() <= PATH_ATOL and d.mean() <= PATH_MEAN_ATOL,
                f"card vs CPU preds at fps={fps}: max {d.max()}, mean {d.mean()}")
        results[str(fps or 30.0)] = {"max_abs_diff": float(d.max()),
                                     "mean_abs_diff": float(d.mean())}
    emit({"phase": "path_parity_cpu_vs_card", "frames": [96, 80],
          "results": results, "tol_max": PATH_ATOL, "tol_mean": PATH_MEAN_ATOL})

    # 5. the training path at full width, and card vs CPU training
    data = (SyntheticAVDataset, WindowSequencer, example_stream)
    counts_train, plain = train_fusion(torch, np, cuda_lib, config, Trainer,
                                       data)
    torch.cuda.empty_cache()
    train_fusion_options(torch, np, cuda_lib, config, Trainer, data,
                         counts_train, plain)
    torch.cuda.empty_cache()
    init_from(torch, config, Trainer, save_pytree, to_jax_params,
              os.path.join(repo, "build", "init_from", "visual.npz"))
    torch.cuda.empty_cache()
    train_parity(torch, np, cuda_lib, config, Trainer, data)
    torch.cuda.empty_cache()
    train_backbones(torch, np, cuda_lib, config, Trainer, data)
    torch.cuda.empty_cache()
    counts_fp32_train = train_fp32(torch, np, cuda_lib, config, Trainer, data)

    # 5b. the data layer and the command line on a fake ABAW tree
    log_dir = os.path.join(repo, "build", "cli_logs")
    data_loader(np, native_loader, repo)
    root = build_fake_abaw(np, repo)
    cli_doctor(np, cli_main.main, root, log_dir)
    ck, trace_dir = cli_train(torch, np, cuda_lib, config, cli_main.main,
                              cli_main.train_stream, root, repo, log_dir)
    cli_inspect_profile(cli_main.main, ck, trace_dir, log_dir)
    cli_eval(np, cli_main.main, root, ck, log_dir)
    cli_predict(cli_main.main, root, ck, repo, log_dir)
    served = cli_export(torch, np, cli_main.main, Predictor, ck, repo, log_dir)
    torch.cuda.empty_cache()
    cli_serve(np, repo, *served, log_dir)
    cli_presets(torch, np, cuda_lib, config, cli_main.main, root, repo, log_dir)
    torch.cuda.empty_cache()
    cli_debug_nans(torch, np, config, Trainer, data)
    torch.cuda.empty_cache()

    # 5c. parallel/: the reference's checkpoint layout, world size 1 over
    # NCCL through the CLI, two gloo ranks on the one card
    resume_jax_layout(torch, np, cuda_lib, config, Trainer, Checkpointer,
                      data, repo)
    torch.cuda.empty_cache()
    ddp_train(torch, np, cuda_lib, config, cli_main.main, repo, log_dir)
    torch.cuda.empty_cache()
    ddp_two_ranks(torch, np, cuda_lib, config, Trainer, data, repo)
    torch.cuda.empty_cache()

    # 5d. the model axis: four gloo ranks as a 2 x 2 mesh, and the
    # sequence-parallel BiGRU on the GRU kernel with a carried-in state
    tp_ranks(torch, np, cuda_lib, config, Checkpointer, Trainer, data, repo)
    torch.cuda.empty_cache()

    # 6. the kernels line, the card line, the result line
    pallas = "m3f/pytorch_tpu/ops/pallas/"
    replaces = {"melspec": pallas + "melspec_pallas.py:88",
                "melspec_n_fft_400": pallas + "melspec_pallas.py:88",
                "gru": pallas + "gru_pallas.py:61",
                "gru_stream": pallas + "gru_pallas.py:61",
                "conv_unit_spatial": pallas + "conv_bn.py:172",
                "conv_unit_temporal": pallas + "conv_bn.py:217",
                "conv_unit_spatial_f32": pallas + "conv_bn.py:172",
                "conv_unit_temporal_f32": pallas + "conv_bn.py:217",
                "conv_spatial_bwd_data": pallas + "conv_bn.py:537",
                "conv_spatial_bwd_filter": pallas + "conv_bn.py:554",
                "conv_temporal_bwd_data": pallas + "conv_bn.py:612",
                "conv_temporal_bwd_filter": pallas + "conv_bn.py:625",
                "conv_spatial_bwd_data_f32": pallas + "conv_bn.py:537",
                "conv_spatial_bwd_filter_f32": pallas + "conv_bn.py:554",
                "conv_temporal_bwd_data_f32": pallas + "conv_bn.py:612",
                "conv_temporal_bwd_filter_f32": pallas + "conv_bn.py:625",
                "packed_conv": "scripts/probe_packed_conv.py:85",
                "ablate_slabs": "scripts/probe_packed_conv.py:139",
                "ablate_matmul": "scripts/probe_packed_conv.py:157",
                "packed_conv_chunked": "scripts/probe_packed_conv.py:207"}
    counter = {"melspec": "melspec", "gru": "gru", "gru_stream": "gru_stream",
               "conv_unit_spatial": "conv_spatial",
               "conv_unit_temporal": "conv_temporal"}
    counter_f32 = {"conv_unit_spatial_f32": "conv_spatial_f32",
                   "conv_unit_temporal_f32": "conv_temporal_f32"}
    source = {"melspec": "m3f_torch/csrc/melspec.cu",
              "melspec_n_fft_400": "m3f_torch/csrc/melspec.cu",
              "gru": "m3f_torch/csrc/gru.cu",
              "gru_stream": "m3f_torch/csrc/gru.cu",
              "conv_unit_spatial_f32": "m3f_torch/csrc/conv_bn_f32.cu",
              "conv_unit_temporal_f32": "m3f_torch/csrc/conv_bn_f32.cu",
              **{k: "m3f_torch/csrc/conv_bn_f32.cu" for k in F32_BWD_KERNELS},
              **{k: "m3f_torch/csrc/packed_conv.cu" for k in PROBE_KERNELS}}
    line = []
    for k in kernels:
        name = k["name"]
        # forward kernels: their launches serving one video (the mel
        # kernel at n_fft 400: serving it so; the GRU's stream route: none,
        # the serving path takes the cluster walk); backward kernels: theirs over
        # the 10 timed train steps (fp32: the F32_TRAIN_STEPS of phase
        # train_fp32); probe kernels: theirs in one probe run
        if name in F32_BWD_KERNELS:
            launches = counts_fp32_train[name]
        elif name in counter:
            launches = counts30[counter[name]]
        elif name in counter_f32:        # serving one video in fp32
            launches = counts_f32[counter_f32[name]]
        elif name == "melspec_n_fft_400":
            launches = counts400["melspec"]
        elif name in PROBE_KERNELS:
            launches = counts_probe[name]
        else:
            launches = counts_train[name]
        line.append({"name": name, "route": "cuda",
                     "source": source.get(name, "m3f_torch/csrc/conv_bn.cu"),
                     "replaces": replaces[name],
                     "launches": launches,
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     **({"ms_per_stage": k["ms_per_stage"]}
                        if "ms_per_stage" in k else {})})
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    print(smi)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--ddp-rank":
        sys.exit(ddp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if len(sys.argv) == 5 and sys.argv[1] == "--tp-rank":
        sys.exit(tp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
