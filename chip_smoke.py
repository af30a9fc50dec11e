#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100): the quickest proof
that the port builds, is right, serves and trains at full width (Cond_SRVAE
in float32, int8, with chained tails and in bfloat16; VAE; SRVAE).

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase's failure is caught):

1. Print torch's version and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from ``simple_vae_rs_tpu_torch/csrc`` (nvcc, one
   process per source, all started together) and print ptxas's registers and
   spills per kernel; a spill in the tensor-core conv kernel, in the chain
   kernel, in any int8 kernel or in the quantizer fails.
3. Hold each kernel against its plain PyTorch version on ragged shapes (for
   the tensor-core kernel, in all three convs: C = 53 and 106, N = 4 and 53,
   odd O, M <= 64 (per phase for the transposed conv) with a K split, K not
   a multiple of 32, C % 4 != 0), and a second launch must give the same
   bits.
4. Build the canonical Cond_SRVAE (cr=1.2, ps=64; random weights from a numpy
   seed) and serve through ``SuperResolver``: ``super_resolve`` on a
   (16, 32, 32, 4) batch, then ``uncertainty`` with 1000 draws. Every launch
   counter is set to 0 just before and read just after; each must be > 0.
   The same requests (same seeds, so the same noise) then run through the
   plain path on the card and must agree.
5. Hold each kernel against its plain version at every distinct shape the
   serving run launched, and time kernel, plain version and one library call
   (cuDNN conv + bias, TF32 off) with CUDA events; compute each shape's bound
   (bytes over 3.35 TB/s or float32 operations over the peak of the units
   the kernel runs on, H100 SXM): for the three conv kernels the tensor
   cores at float32 accuracy (495/3 TFLOP/s: three TF32 products per
   float32 one). The CUDA-core figure (67 TFLOP/s) is also reported
   (``bound_cuda_core_ms``), beside ``bound_tc_ms``.
6. Train: the canonical model from ``init_weights(0)``, 32 synthetic tiles
   (LR 128x128x4, HR 256x256x4, values x1000, numpy seed 0) cut by the
   port's ``grid_sr_batch`` on the card into 512 pairs, and
   ``Trainer.train_step`` / ``val_step``. The counters are set to 0 just
   before one train step and read just after, by kernel and role (forward,
   input gradient "dx"), and asserted against the calls hooks recorded; the
   same for one val step. Then 1 more warm-up step and 5 timed steps
   (synchronised, median), patches/s and peak memory.
7. Hold each kernel and role against its plain version at every distinct
   training shape and time it, with the library call that computes the same
   function (cuDNN forward for a forward role, cuDNN backward-data for a dx
   role, none for the row reductions); time the library weight-gradient
   calls (not a kernel port: the JAX package leaves them to XLA), each held
   against float64 on 2 images so TF32 cannot slip in, and give each
   part's share of the step.
8. Two copies of the model take one step on the same batch and noise, one
   through the kernels and one through the plain path (which must launch
   nothing): loss terms, every gradient leaf, BatchNorm statistics and the
   parameters after the step must agree; then one val step each.

Between phases 5 and 6, the int8 serving modes (the model of phase 4):

I1. Hold each int8 conv kernel (activation absmax pass, quantize pass and
    W8A8 conv on the int8 tensor cores: #9, #11 and #12) against its exact
    plain version on ragged shapes, bit for bit: odd H/W, C = 3, 4, 5, 6, 7,
    130, 300 and 424, O = 5, 9, 13, 70 and 200, K splits, ``act_group``
    smaller than the batch; the quantize pass bit for bit too.
I2. The stochastic-round quantizer on the canonical W8A8 tree (the 18
    decoder kernels) in one C call: every leaf the same bytes, q and scales,
    as its plain version, ``|q - w/scale| < 1`` everywhere, the mean error
    within 4 standard errors of 0 per leaf, the same bytes on a second call,
    other bytes for another leaf's seed; the tree timed (CUDA events and
    profiler device time) against its bytes bound.
I3. ``SuperResolver(model, int8=True)``: every counter is set to 0, the
    resolver is built (which quantizes the tree: 2 launches), then ``super_resolve``
    B=16 and ``uncertainty`` N=1000 run; the counters must equal the calls
    the hooks recorded and the expected numbers (per request: int8 3x3 x7,
    int8 convT x2, the absmax pass x9, the quantize pass x9, float 3x3 x17,
    4x4/s2 x5, convT x1).
    The same requests run through the plain path on the card and must
    agree; PSNR against the float32 resolver of phase 4 on the same seeds
    (so the same noise) must exceed 30 dB. Median latencies, peak memory.
I4. The int8 4x4/s2 kernel through the block path: six ``DownBlock``s at the
    canonical shapes (B=16), each given a ``quant`` tree (one quantizer call
    of 2 launches a block, its bytes held against the plain version and
    timed), against the plain path; counters set to 0 before and read after
    (their 3x3 convs run #9, and every int8 conv its quantize pass: 12).
I5. Each int8 kernel against its plain version at every distinct shape I3
    and I4 launched, timed, with the float32 kernel's time at the same shape
    and the bound (bytes over 3.35 TB/s or integer operations over the 1,979
    TOP/s int8 tensor-core peak). No single PyTorch call computes a W8A8
    conv with in-call quantization, so these have no library time; the
    absmax pass has one (``torch.linalg.vector_norm`` with ord=inf). The
    absmax pass is also timed by ``torch.profiler`` (device time of its
    kernel and its result's memset: CUDA events around one call of a few
    microseconds measure the wrapper), with its share of the bytes bound.
    The quantize pass is timed alone against its bytes bound, each int8
    conv call (absmax, quantize and conv) also by the profiler
    (``device_ms``), and beside each int8 conv stands cuBLASLt's int8 GEMM
    (``torch._int_mm``) at the same (M, N, K) on operands im2col'd outside
    the timing (``gemm_ms``): a yardstick of the tensor-core rate, not the
    same function, so ``library_ms`` stays null.
I6. ``SuperResolver(model, int8_weights=True)``: the same two requests, the
    float kernels' launch counts of phase 4, PSNR against float32 above
    30 dB, and no packed leaf held in float32 between requests.

After the int8 phases, the chain kernel and chained serving (the model of
phase 4), and after phase 8 the chained val step and the other two families:

C1. Hold the chain kernel (n 3x3 convs in one launch) against its plain
    version on ragged shapes (one, two and four layers, odd H, W and widths,
    a 40-channel input, one image in many strips, an image too wide for full
    rows, a layer wider than one n tile) and at every chain the canonical
    models launch, at the batch sizes of their paths (1, 16, 512, 1000).
C2. ``SuperResolver(model, chain=True)``: counters set to 0, ``super_resolve``
    B=16 and ``uncertainty`` N=1000; launches asserted against hooks and the
    expected numbers (3x3 16 and chain 2 per request in place of 3x3 24: for
    ``uncertainty`` 13 + 1 in the prior pass and 3 + 1 in the decode);
    outputs within 1e-4 of the unchained resolver of phase 4 on the same
    noise and of the plain path. ``SuperResolver(model, int8=True,
    chain=True)``: the launches of I3 unchanged and no chain (a model with
    int8 weights chains no tail, as the JAX ``tail_chain`` steps aside),
    outputs within 2e-3 of the unchained W8A8 resolver.
C3. One val step of the canonical Cond_SRVAE at B=512, unchained (3x3 37)
    and chained (3x3 21, chain 4); loss terms within 1e-4 relative.
C4. The canonical VAE (cr=1.5, ps=32): ``sample_chunked`` with 1000 draws of
    one 32x32 window, unchained, chained (chain 1 for the encoder and 1 per
    decode chunk) and on the plain path, on the same injected noise; one
    train step and one chained val step at B=512 with the launch counts
    asserted against hooks; then phase 8's comparison with the plain path.
    The canonical SRVAE: ``super_resolve`` B=16 chained from HR-sized input
    and from the LR view of the same input (equal outputs, the launch counts
    of C2), one train step and chained val step, and phase 8's comparison.
C5. Timing by CUDA events per chain shape: the chain, the per-layer kernel
    launches it replaces, the plain version, and one cuDNN call per layer
    (TF32 off; no single PyTorch call computes a chain, so the kernel's
    ``library_ms`` is null); the bound (bytes of input, output and weights
    over 3.35 TB/s, or float32 operations over the 3xTF32 tensor-core peak
    the chain runs on, 495/3 TFLOP/s) and the chain's share of it, with the
    CUDA-core figure (67 TFLOP/s) beside. Request latencies chained beside
    unchained, in turns, float32 and W8A8.

After phase C4, bfloat16 compute (models built with ``dtype=torch.bfloat16``;
the bfloat16 instances of #1, #5 and #6 in ``csrc/fused_conv.cu``):

B1. Each bfloat16 instance against its plain version in both roles (forward
    and input gradient) at the ragged shapes of phase 3 and at C % 8 == 0
    beside C % 8 != 0: within one bfloat16 ulp at the element plus 1e-4 of
    max|plain| (``fused_conv.compare_bf16``; the share bit-equal printed),
    the same bits on a second launch. Then ``conv_wg_bf16``
    (``csrc/conv_wg.cu``, #1, #5 and #6 on wgmma fed by TMA) the same way at
    ``RAGGED_WG``'s shapes (C % 64 != 0, O = 8, 24 and 136, a batch that is
    not a multiple of the box's images, a row wider than one box; #5 on 8x8,
    4x4 and odd output grids and a 128-wide output row), the dx role also
    through ``input_grad`` (the flip-swapped weight it makes), counted under
    "wg". Phase 2 prints ``ptxas conv_tc_bf16`` and ``ptxas conv_wg_bf16``
    and fails on a spill there, or on a ``conv_wg_bf16`` instance at another
    register count than 168.
B2. The canonical Cond_SRVAE in bfloat16 (phase 4's weights) through
    ``SuperResolver`` (unchained; chained in B9):
    ``super_resolve`` B=16 and ``uncertainty`` N=1000 on phase 4's seeds;
    bfloat16 launches by kernel and role equal the hooks' and no float32
    kernel launches; by kernel that ran ("wg" or "tc",
    ``fused_conv.bf16_impl_launches``) they equal the static rule
    (``fused_conv.wg_route`` of each hooked call; here and in B3 and B4),
    with #1 and #6 forward on "wg" (``WG_SERVING_ROLES``; in B3 also #5 in
    both roles, ``WG_STEP_ROLES``); outputs float32 in [0, 1], within 2e-2 of the plain
    path in bfloat16 on the card, PSNR against phase 4's float32 outputs
    above 40 dB.
B3. One Cond_SRVAE train step in bfloat16 at B=512, ``bf16_moments`` off
    then on: launches against hooks, finite terms, median of 5 steps, peak
    memory beside the float32 step's; then phase 8's comparison with
    bfloat16 tolerances (``BF16_STEP_TOLS``: each gradient leaf within 2x
    its own bfloat16 error, the float32 plain path against the bfloat16
    one, + 1e-3 of its block's max); one val step.
B4. The canonical VAE and SRVAE in bfloat16: one request (1000 draws of one
    window, against the plain path; ``super_resolve`` B=16 from HR input)
    and one train step each, launches counted; each request also chained
    (B9: the chain's bfloat16 instance, C4's chain counts, within 2e-2 of
    the unchained request).
B5/B6. Every distinct bfloat16 shape of B2 and B3, checked as in B1 and
    timed: the bfloat16 instance the shape is routed to, its plain version,
    one cuDNN call in bfloat16 and the float32 kernel at the same shape,
    and the bound (bytes over 3.35 TB/s or operations over the 989 TFLOP/s
    bf16 tensor-core peak); where ``conv_wg_bf16`` takes the shape, both
    bfloat16 kernels, each checked, timed in turns (tc, wg, wg, tc), and the
    routed shapes where wg was the slower printed; sums by kernel, kernel
    that ran, path and role, and #5's per role over all three paths (the
    routed kernels, ``conv_tc_bf16`` at every launch, cuDNN bfloat16, the
    bound). The kernels line gets six more entries, ``<kernel>_bf16_wg`` and
    ``<kernel>_bf16_tc`` for #1, #5 and #6 (the wg ones with the parent
    ``conv_tc_bf16``'s time at the same launches, ``tc_ms``).

Then the bfloat16 int8 and chain instances (``csrc/int8_conv.cu``'s and
``csrc/conv_chain.cu``'s ``*_bf16`` entry points; phase 2 prints their
ptxas lines and fails on a spill):

B7. The bfloat16 absmax pass, quantize pass and ``int8_tc`` (#9, #11, #12)
    at I1's ragged shapes against their plain versions, bit for bit (q, the
    scales and the output; the same bits on a second launch).
B8. ``SuperResolver(bf16 model, int8=True)`` and ``(..., int8_weights=True)``
    on the canonical model (phase 4's weights in bfloat16): ``super_resolve``
    B=16 and ``uncertainty`` N=1000, counters set to 0 before each request
    and read after; the bfloat16 int8 counts equal I3's float32 ones and no
    float32 instance launches; outputs float32, within 2e-2 of the same
    requests on the plain path on the card, above 30 dB against phase 4's
    float32 outputs. I4's DownBlocks in bfloat16 (#11), equal to the plain
    path bit for bit. Every distinct bfloat16 int8 shape checked bit for
    bit and timed: the call, its plain version, the bfloat16 #1/#5/#6 kernel
    and one cuDNN bfloat16 call on the dequantized weights, cuBLASLt's int8
    GEMM, the passes alone, the bound (bfloat16 bytes at 3.35 TB/s against
    1,979 TOP/s).
B9. The chain's bfloat16 instance at C1's ragged shapes (one to eight
    layers, strips and panels) and every chain of the canonical models:
    each layer within one bfloat16 ulp at the element plus 1e-4 of
    max|plain| of the plain layer on the kernel's own input
    (``fused_conv.compare_bf16``), the whole chain within the noise rule
    (2x the plain bfloat16 chain's distance from the float32 chain, plus
    1e-4 of max|plain|: each layer rounds to bfloat16, so one ulp apart at a
    layer is carried on), the same bits twice; timed beside the bfloat16 #1
    launches it replaces, the plain version and one cuDNN bfloat16 call per
    layer, the bound at 989 TFLOP/s. ``SuperResolver(bf16 model,
    chain=True)``: C2's chain counts, outputs within 2e-2 of B2's unchained
    ones; with ``int8=True`` no chain launches.

After the kernels line's counts are taken, phase F, the training run end to
end on the canonical Cond_SRVAE (cr=1.2, ps=64) at full width, on batches
of 512 pairs from ``grid_sr_batch`` on the card (3 train, 1 val):

F1. The launches of one step of each kind (pre-training, train, val, eval
    metrics, eval images) on a probe trainer; then ``pretrain_lr_branch``
    for 1 pre-epoch and ``fit`` for 2 epochs at ``val_metrics_every=1`` with
    ``ModelCheckpoint``, ``EarlyStopping`` and a ``JsonlLogger`` in a
    temporary directory under ``build/``. The launches by kernel and role
    must equal the per-step counts times the steps, the logged keys the
    JAX fit's (``engine.FIT_KEYS``), every loss finite.
F2. ``SuperResolver.from_checkpoint`` of the best checkpoint serves
    ``super_resolve`` B=16 and ``uncertainty`` N=1000 to the same bits as a
    resolver over the model state the checkpoint was written from;
    ``from_checkpoint(int8=True)`` above 30 dB against it.
F3. Resume: 1 epoch, save, and epoch 2 in a fresh trainer loaded from the
    checkpoint against the first trainer going on, both with
    ``cudnn.deterministic`` (cuDNN's weight gradients are the one
    library call whose algorithm may not be deterministic): the parameters,
    statistics, moments and logged metrics the same bits.
F4. One step with ``remat`` against one without from one state and noise:
    the forward role's conv launches double (the forward is recomputed in
    the backward), the gradients within phase 8's noise rule, the
    BatchNorm statistics the same bits (updated once); peak memory of both.
F5. A bfloat16 model with ``bf16_moments``: 1 epoch, save, load: ``mu``
    back in bfloat16, parameters and moments the same bits.

F prints the epoch seconds, the checkpoint save and load ms, the
``from_checkpoint`` build ms and the peak memory, each beside the card's
name and power limit; the temporary directory is removed at the end.

Then phase G, training from tiles on disk through the command line
(``simple_vae_rs_tpu_torch.cli.main`` in-process, in a temporary directory
under ``build/``, where it writes ``ckpt/``, ``runs/`` and ``results/``):

G0. ``python -m simple_vae_rs_tpu_torch.make_index ARM --validate`` writes
    the tree's ``index.csv`` (every pair opened and its 2x geometry
    checked): its rows must be the pairs the tree was written with.
G1. An ARM-shaped tree: 160 tile pairs (HR 256x256x4, LR 128x128x4, int16
    digital numbers from ``SyntheticHFDataset`` scenes, LZW with the
    predictor), written with the port's ``write_tiff``. Every file read
    back equal; every strip decoded by the native codec, which equals the
    Python decoder on a strip; the write seconds and the decode rate on one
    thread.
G2. ``--dataset s2v --crop grid --batch_size 32 --patch_size 64 -cr 1.2
    --epochs 2 --pre_epochs 1 --val_metrics_every 1 --samples 1000
    --tensorboard --workers 4`` (4 steps of 512 pairs an epoch, 1 val
    batch): the launches by kernel and role equal phase F's per-step counts
    times the steps plus one ``run_task``'s, the logged keys the JAX fit's,
    a checkpoint written, the MMSE finite, the tfevents file read back.
G3. A train epoch from disk against one from the same batches held on the
    card, in f32 and bf16, at ``--workers`` 1 and 4: the seconds the step
    waited on the loader's queue (the first batch's apart), how much longer
    the steps took than from memory besides, the copies' and the crops'
    time on the card, and which of the loader and the step sets the pace
    (the loader where either of those two exceeds 5% of the epoch from
    memory).
G4. A resume with ``--model_ckpt --epochs 3`` (it starts after the saved
    epoch, the scheduler's state carried over); ``--test --model_ckpt``
    with no model flags (they come from the meta; the launches are
    ``run_task``'s alone); ``--test --int8`` (#8, #9, #12 and the passes
    launched).
G5. ``--bf16 --bf16_moments``, one epoch: ``conv_wg_bf16`` launches
    counted, the first moment in bfloat16.
G6. ``evaluate`` on a val tile super-resolved by the trained model patch by
    patch, reassembled with ``grid_unpatchify``, against its HR tile with
    ``--lr``: in memory and ``--stream`` agree within 1e-4 where one window
    covers the tile.
G7. ``doctor`` exits 0 and prints the card's name and power limit.

Then phase H, serving a whole raster, in the same temporary directory: the
scene is an 8x8 mosaic of G1's LR tiles, a 1024x1024x4 int16 LZW GeoTIFF
(a 10.24 km square of Sentinel-2 10 m bands: 1369 windows of 32 px at
overlap 4, 86 dispatches of 16). Every path below runs with every counter
set to 0 just before it and read just after, and its launches must equal
a probe's per-dispatch counts times its dispatches, with #1, #5 and #6 each
launched:

H1. Phase 4's weights in float32 and bfloat16 through ``SuperResolver``'s
    tile endpoints: ``super_resolve_tile`` on a 512x512x4 crop (361
    windows, 23 dispatches) and ``uncertainty_tile`` with 32 draws on
    256x256x4 (81 windows, 6 moments dispatches of 32 draws); against the
    plain path on the same seeds (float32 1e-4, bfloat16 2e-2 and 40 dB
    against float32; the mean and the variance, the std being the sqrt of
    the latter), a seeded repeat bit-equal, an ``iter_tile_rows`` sweep
    resumed at its middle band bit-equal; ms per request, windows/s, the
    host ms in ``stitch``, and one traced request's card-busy ms.
H2. ``python -m simple_vae_rs_tpu_torch.raster``'s ``main`` with phase G's
    checkpoint: in memory (the product equals ``super_resolve_tile``'s to
    the bit), ``--stream``, ``--stream --resume --request_seed 7`` failing
    after band 3 and resumed (the uninterrupted sweep's bytes),
    ``--uncertainty`` (a finite float32 std map), ``--int8`` (#8, #9, #12
    and the passes launched) and ``--int8_weights``; every output int16 at
    2048x2048x4 in the input's band layout; the seconds of each run.
H3. ``make_server`` on a thread, driven by the port's ``Client``: the
    ``/healthz`` and reply keys the JAX server's; a seeded B=16 request
    over the float32 npy wire the in-process bits, over the u16 wire within
    half a step (``wire.py``'s bound, float32's rounding beside); a seeded tile stitched by the server equal to the same request
    stitched by ``RemoteResolver``; ``raster --url`` (in memory and
    ``--stream``) equal to the local products; the HTTP round trip against
    the in-process call for B=16 and for 32-draw moments; at
    ``--dynamic_batch_ms 2``, 8 concurrent unseeded B=1 requests in whole
    dispatches, no more than the requests (printed, not bounded in time).

Then phase J, the checkpoint tools and the artifact, on phase G's
checkpoint (the canonical Cond_SRVAE) in the same temporary directory:

J1. ``convert_checkpoint --to_torch`` (strict and ``--keep_gammas``), each
    ``.pth`` imported back: the same weights (the strict one's gammas 1.0);
    ``SuperResolver.from_checkpoint`` of the import serves a seeded B=16
    request bit-equal to G's weights under the reference's latent wiring
    (``torch_regroup``, which the import records), #1, #5 and #6 launched;
    the seconds of each step.
J2. ``export_checkpoint`` with ``--weights`` f32, bf16 and int8, each loaded
    on the card: every counter stays 0 through every artifact request (the
    artifact is the plain graph); a seeded B=16 request off the f32
    artifact within 1e-4 of the live resolver's plain path on the same
    seed, bf16 and int8 at 30 dB or more against it; a seeded 512x512x4
    tile bit-equal on repeat; file MB, export and load seconds, the B=16
    request's median of 5 beside the live resolver's, the tile's ms.
J3. ``make_server`` on the f32 artifact: ``/healthz`` holds the JAX artifact
    branch's keys; a seeded B=16 request over HTTP is the in-process bits;
    ``raster --url`` on H's scene equals the artifact's own product.

The kernels line's entries carry ``launches_phase_h`` and
``launches_phase_j``, each H and J path's count.

Output: per-shape lines, a ``{"kernels": [...]}`` line (each kernel's
launches, times and bounds summed over the serving run, one train step and
one val step; for the int8 kernels over the int8 serving run and the block
path; an int8 conv's time includes its absmax and quantize passes, each also
listed on its own; the quantizer's over its seven trees; for the chain over
the chained runs of C2-C4), then the last line
``{"ok": true, "device": {...}}``. A per-shape report is written to
``chiprun_out/chip_smoke_report.json``. Exits non-zero without a CUDA card.

Tolerances: kernel vs plain max|diff| <= 1e-4 * max|plain| (float32 both,
summed in another order); row reductions 1e-5 * max|plain| (every element
term is >= 0); served outputs in [0, 1] within 1e-4. The training step,
kernels vs plain path: loss terms and BatchNorm statistics relative 1e-4;
each gradient leaf max|diff| <= 8 * the same leaf's max|diff| between the
plain path and the plain path on the permuted batch (the same function,
summed in another order: float32's own noise) + 1e-4 * the largest |plain
gradient| of its block (top-level module). A fixed share of the leaf does
not hold at B=512: the weight gradient of a conv that BatchNorm follows is
a long sum that cancels, and the permuted batch alone moves it by up to
0.6% of the leaf's largest value; the bias of such a conv has a true
gradient of 0. Parameters after the step within 2 * lr (Adam's first step
moves a weight by about lr * sign(g)), and 99% of all elements within
1e-2 * lr. Int8: the three convs and the quantize pass equal to their plain
versions to the last bit (the same integers summed exactly on both sides,
the same float32 epilogue); the quantizer byte for byte; the int8 resolver vs its plain path 2e-3 absolute
(the float32 layers above the decoder differ in the last bits, so a few
activations on a rounding boundary quantize one step apart), with the share
of elements beyond 1e-5 printed.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# H100 SXM TF32 tensor cores (495 TFLOP/s dense) at float32 accuracy: three
# TF32 products per float32 product (3xTF32, the three conv kernels)
PEAK_F32_TC_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = 1e-4  # of max|plain|
ROW_TOL = 1e-5  # of max|plain|
SERVE_TOL = 1e-4  # absolute, on outputs in [0, 1]
TERMS_TOL = STATS_TOL = 1e-4  # relative
GRAD_TOL = 1e-4  # of the largest |plain gradient| in the leaf's block, beside
NOISE_FACTOR = 8.0  # times float32's own noise: the plain path on the permuted batch
SOURCE = "simple_vae_rs_tpu_torch/csrc/fused_conv.cu"
ROW_SOURCE = "simple_vae_rs_tpu_torch/csrc/elbo_rows.cu"
INT8_SOURCE = "simple_vae_rs_tpu_torch/csrc/int8_conv.cu"
TC_INT8 = ("int8_conv3x3_bn_relu", "int8_conv4x4s2_bn_relu", "int8_convT4x4s2_bn_relu")
QUANT_SOURCE = "simple_vae_rs_tpu_torch/csrc/quantize.cu"
PEAK_INT8_OPS = 1979e12  # H100 SXM, int8 tensor cores, dense
BF16_MANGLED = "13__nv_bfloat16"  # a bfloat16 template argument in a kernel's mangled name
INT8_TOL = 1e-5  # of max|plain|
INT8_SERVE_TOL = 2e-3  # absolute, on outputs in [0, 1]
MIN_PSNR_DB = 30.0
REPLACES = {
    "fused_conv3x3_bn_relu": "simple_vae_rs_tpu/ops/pallas_conv.py:128",
    "fused_conv4x4s2_bn_relu": "simple_vae_rs_tpu/ops/pallas_conv.py:682",
    "fused_convT4x4s2_bn_relu": "simple_vae_rs_tpu/ops/pallas_conv.py:792",
    # pallas_elbo._rows_call (:135) with each row kernel's body
    "sq_rows": "simple_vae_rs_tpu/ops/pallas_elbo.py:167",
    "kl_std_rows": "simple_vae_rs_tpu/ops/pallas_elbo.py:200",
    "kl_gen_rows": "simple_vae_rs_tpu/ops/pallas_elbo.py:239",
    "quantize_stochastic": "simple_vae_rs_tpu/ops/quantize.py:92",
    # the absmax half of _quant_act (:67), which the TPU kernels run in-kernel
    "act_absmax": "simple_vae_rs_tpu/ops/pallas_int8.py:67",
    # its quantize half, run once per tile in-kernel (called at :98)
    "act_quant": "simple_vae_rs_tpu/ops/pallas_int8.py:67",
    # with its row-strip variant _int8_conv3x3_strips (:169)
    "int8_conv3x3_bn_relu": "simple_vae_rs_tpu/ops/pallas_int8.py:216",
    "int8_conv4x4s2_bn_relu": "simple_vae_rs_tpu/ops/pallas_int8.py:328",
    "int8_convT4x4s2_bn_relu": "simple_vae_rs_tpu/ops/pallas_int8.py:441",
}
# (name, x shape, O, relu, act_group): C = 3, 4, 5, 6, 7, 130, 300 and 424
# (padded to 16, 16, 16, 16, 16, 144, 304, 432), O = 5, 9, 13, 70 and 200
# (weight rows not whole 16-byte words), every tile, K splits in all three
# modes, short last groups, odd H and W
RAGGED_INT8 = [
    ("int8_conv3x3_bn_relu", (3, 5, 7, 3), 5, True, None),
    ("int8_conv3x3_bn_relu", (5, 9, 11, 6), 13, False, 2),
    ("int8_conv3x3_bn_relu", (1, 4, 4, 300), 200, False, None),
    ("int8_conv3x3_bn_relu", (3, 5, 7, 7), 9, True, 2),
    ("int8_conv3x3_bn_relu", (2, 9, 9, 130), 70, False, 1),
    ("int8_conv3x3_bn_relu", (3, 6, 7, 5), 30, True, None),
    ("int8_conv3x3_bn_relu", (1, 4, 4, 424), 424, False, None),
    ("int8_conv4x4s2_bn_relu", (3, 6, 10, 5), 7, True, 1),
    ("int8_conv4x4s2_bn_relu", (2, 7, 9, 3), 20, False, None),
    ("int8_conv4x4s2_bn_relu", (5, 9, 11, 4), 13, True, 2),
    ("int8_conv4x4s2_bn_relu", (1, 8, 8, 130), 200, False, None),
    ("int8_conv4x4s2_bn_relu", (2, 12, 13, 5), 70, True, 1),
    ("int8_convT4x4s2_bn_relu", (2, 3, 5, 7), 9, True, None),
    ("int8_convT4x4s2_bn_relu", (4, 4, 4, 130), 70, False, 3),
    ("int8_convT4x4s2_bn_relu", (3, 5, 6, 5), 13, True, 2),
    ("int8_convT4x4s2_bn_relu", (1, 9, 9, 64), 200, False, None),
    ("int8_convT4x4s2_bn_relu", (1, 4, 4, 424), 256, True, None),
]
# (in, out, H = W) of the canonical model's DownBlocks: LR 32 px and HR 64 px
DOWN_BLOCKS = [(4, 16, 32), (16, 64, 16), (64, 128, 8), (4, 16, 64), (16, 64, 32), (64, 128, 16)]
INT8_EXPECTED = {  # launches of one super_resolve or one uncertainty of the int8 resolver
    "int8_conv3x3_bn_relu": 7, "int8_convT4x4s2_bn_relu": 2, "int8_conv4x4s2_bn_relu": 0,
    "act_absmax": 9, "act_quant": 9, "fused_conv3x3_bn_relu": 17, "fused_conv4x4s2_bn_relu": 5,
    "fused_convT4x4s2_bn_relu": 1,
}
ROW_OPS = {"sq_rows": 3, "kl_std_rows": 5, "kl_gen_rows": 11}  # float ops per element
LR = 1e-4
RAGGED = [
    ("fused_conv3x3_bn_relu", (3, 5, 7, 5), 13, True),
    ("fused_conv3x3_bn_relu", (2, 9, 11, 4), 3, False),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 300), 200, False),
    # the tensor-core kernel's edge paths: C = 53 and 106 (4-byte copies),
    # N = 4 and 53, M <= 64 with a K split and K = 1908 (not a multiple of 32),
    # the 4x4/s2 kernel with C % 4 != 0; for the transposed conv the same, with
    # M <= 64 per phase (K splits at K = 1696 and 424, odd O = 13)
    ("fused_conv3x3_bn_relu", (2, 8, 8, 53), 53, True),
    ("fused_conv3x3_bn_relu", (3, 8, 8, 106), 128, False),
    ("fused_conv3x3_bn_relu", (4, 16, 16, 16), 4, True),
    ("fused_conv3x3_bn_relu", (1, 4, 4, 212), 848, False),
    ("fused_conv4x4s2_bn_relu", (2, 16, 16, 128), 53, False),
    ("fused_conv4x4s2_bn_relu", (1, 8, 8, 53), 424, True),
    ("fused_conv4x4s2_bn_relu", (3, 6, 10, 5), 7, True),
    ("fused_conv4x4s2_bn_relu", (2, 7, 9, 3), 20, False),
    ("fused_convT4x4s2_bn_relu", (2, 3, 5, 7), 9, True),
    ("fused_convT4x4s2_bn_relu", (1, 4, 4, 130), 70, False),
    ("fused_convT4x4s2_bn_relu", (2, 8, 8, 53), 128, True),
    ("fused_convT4x4s2_bn_relu", (4, 16, 16, 16), 4, False),
    ("fused_convT4x4s2_bn_relu", (2, 8, 8, 128), 53, True),
    ("fused_convT4x4s2_bn_relu", (1, 4, 4, 424), 256, False),
    ("fused_convT4x4s2_bn_relu", (1, 3, 4, 106), 13, True),
]


def log(*args):
    print(*args, flush=True)


def tensor_core_ptxas(report: str, kernel: str = "conv_tc", expect: int = 0) -> str:
    """Registers of the kernels whose name holds ``kernel`` (every kernel of
    the report for "") from ptxas's ``-v`` report (the tensor-core kernels'
    shared memory is dynamic); fails if one of them spills, or if there are
    not ``expect`` of them (any number for 0)."""
    current, regs, entries = "", [], 0
    for line in report.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        elif kernel in current and "spill stores" in line:
            entries += 1
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            if len(nums) < 3 or nums[1] or nums[2]:
                raise AssertionError(f"ptxas: {current} spills: {line.strip()}")
        elif kernel in current and "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
    if not entries or len(regs) != entries:
        raise AssertionError(f"ptxas: no report for the {kernel or 'int8'} kernels")
    if expect and entries != expect:
        raise AssertionError(f"ptxas: {entries} {kernel} instances, expected {expect}")
    return f"{entries} instances, {min(regs)}-{max(regs)} registers, no spills"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_fn(name, x, kernel, scale, shift, relu):
    """One cuDNN call computing the same function (scale folded into the
    weights beforehand): the yardstick, never used by the port."""
    xn = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    # in x's dtype (cuDNN takes a bfloat16 conv with bfloat16 weights and bias)
    folded, shift = (kernel * scale).to(x.dtype), shift.to(x.dtype)
    if name == "fused_convT4x4s2_bn_relu":
        wt = folded.flip(0, 1).permute(2, 3, 0, 1).contiguous()

        def call():
            y = F.conv_transpose2d(xn, wt, shift, stride=2, padding=1)
            return F.relu(y) if relu else y
    else:
        wt = folded.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        stride, pad = (2, 1) if name == "fused_conv4x4s2_bn_relu" else (1, 1)

        def call():
            y = F.conv2d(xn, wt, shift, stride=stride, padding=pad)
            return F.relu(y) if relu else y
    return call


def library_dx(site, g, kernel):
    """One cuDNN backward-data call computing the input gradient of conv
    ``site`` from ``g``, where ``kernel`` is the flip-swapped weight its dx
    kernel takes (``flip_swap`` is its own inverse)."""
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    k_site = fc.flip_swap(kernel)
    in_shape = fc.output_shape(fc.DX_KERNEL[site], g.shape, kernel.shape[-1])
    gn = g.permute(0, 3, 1, 2)
    xn = torch.empty(in_shape, device=g.device, dtype=g.dtype).permute(0, 3, 1, 2)
    if site == "fused_convT4x4s2_bn_relu":
        w, stride, transposed = k_site.flip(0, 1).permute(2, 3, 0, 1).contiguous(), 2, True
    else:
        w, transposed = k_site.permute(3, 2, 0, 1).contiguous(), False
        stride = 2 if site == "fused_conv4x4s2_bn_relu" else 1

    def call():
        return torch.ops.aten.convolution_backward(
            gn, xn, w, None, [stride, stride], [1, 1], [1, 1], transposed, [0, 0], 1,
            [True, False, False])[0]
    return call


def check_shape(fc, name, shape, o, relu, seed, timing: bool, site=None):
    """Kernel vs plain version at one shape; with ``timing``, also the times.
    ``site`` names the conv whose input gradient the call computes (the dx
    role: unit scale, zero shift, no ReLU, library = backward-data)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if name == "fused_conv3x3_bn_relu" else 4
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda")
    kernel = torch.randn((k, k, c, o), generator=gen, device="cuda") / math.sqrt(k * k * c)
    if site is None:
        scale = torch.rand((o,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((o,), generator=gen, device="cuda")
    else:
        scale, shift = torch.ones(o, device="cuda"), torch.zeros(o, device="cuda")
    got = getattr(fc, name)(x, kernel, scale, shift, relu=relu)
    want = fc.PLAIN[name](x, kernel, scale, shift, relu)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    if not (err <= KERNEL_TOL * ref) or not torch.isfinite(got).all():
        raise AssertionError(f"{name} {shape}->{o}: max|diff| {err} > {KERNEL_TOL} * {ref}")
    if not timing and not torch.equal(getattr(fc, name)(x, kernel, scale, shift, relu=relu), got):
        raise AssertionError(f"{name} {shape}->{o}: a second launch gave other bits")
    row = {"name": name, "role": "forward" if site is None else "dx", "x": list(shape),
           "o": o, "relu": relu, "max_abs_err": err, "max_abs_ref": ref}
    if timing:
        if site is None:
            lib = library_fn(name, x, kernel, scale, shift, relu)
        else:
            lib = library_dx(site, x, kernel)
        lib_err = float((lib().permute(0, 2, 3, 1) - want).abs().max())
        if not lib_err <= KERNEL_TOL * ref:
            raise AssertionError(f"library call disagrees at {name} {shape}: {lib_err}")
        first = cuda_ms(lambda: getattr(fc, name)(x, kernel, scale, shift, relu=relu), 1)
        reps = max(3, min(50, int(30.0 / max(first, 1e-3))))
        row["ms"] = cuda_ms(lambda: getattr(fc, name)(x, kernel, scale, shift, relu=relu), reps)
        row["plain_ms"] = cuda_ms(lambda: fc.PLAIN[name](x, kernel, scale, shift, relu), reps)
        row["library_ms"] = cuda_ms(lib, reps)
        m, n, kk, phases = fc.geometry(name, x, kernel)
        flops = 2.0 * phases * m * n * kk
        nbytes = 4.0 * (x.numel() + kernel.numel() + 2 * o + got.numel())
        row["flops"], row["bytes"] = flops, nbytes
        peak = conv_peak(fc, name)
        row["bound_ms"] = 1e3 * max(flops / peak, nbytes / PEAK_BYTES)
        row["bound_by"] = "operations" if flops / peak > nbytes / PEAK_BYTES else "bytes"
        row["bound_cuda_core_ms"] = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        row["bound_tc_ms"] = tc_bound_ms(flops, nbytes)
    return row


def conv_peak(fc, name):
    """The peak rate of the units a float32 conv kernel runs on: the 3xTF32
    tensor cores for the kernels of ``fc.TC_KERNELS`` (all three convs), the
    CUDA cores for any other. ``bound_ms`` and ``bound_by`` use it."""
    return PEAK_F32_TC_FLOPS if name in fc.TC_KERNELS else PEAK_F32_FLOPS


def tc_bound_ms(flops, nbytes):
    """The 3xTF32 bound of a float32 conv: its operations over the
    tensor-core peak at float32 accuracy, or its bytes, whichever takes longer."""
    return 1e3 * max(flops / PEAK_F32_TC_FLOPS, nbytes / PEAK_BYTES)


def tc_columns(tot):
    """A float32 conv kernel's 3xTF32 bound (165 TFLOP/s) and its share of
    it, beside ``bound_ms``: for the four kernels on the tensor cores (the
    three convs and the chain) the two are the same, and
    ``bound_cuda_core_ms`` is the CUDA-core figure."""
    return {"bound_tc_ms": tot["bound_tc_ms"], "share_of_bound_tc": tot["bound_tc_ms"] / tot["ms"]}


def randomize_bn(model, seed: int) -> None:
    """Non-trivial BatchNorm parameters and running statistics (numpy seed),
    so the folded tails are exercised."""
    from simple_vae_rs_tpu_torch.ops.conv_blocks import BatchNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.scale.numel()
                for t, vals in ((mod.scale, rng.uniform(0.8, 1.2, n)),
                                (mod.bias, rng.normal(0.0, 0.1, n)),
                                (mod.mean, rng.normal(0.0, 0.1, n)),
                                (mod.var, rng.uniform(0.5, 1.5, n))):
                    t.copy_(torch.from_numpy(vals.astype(np.float32)))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def record_conv_calls(model, calls):
    """Hooks recording every conv launch the model's next passes make, as
    ``(kernel, role, kernel input shape, O, relu, site, site input shape)``:
    a forward call when a conv runs, and a dx call when autograd computes the
    gradient of a conv's input (a tensor hook, so only inputs that need one)."""
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    def site(name, x, o, relu):
        shape = tuple(x.shape)
        calls.append((name, "forward", shape, o, relu, name, shape))
        if x.requires_grad:
            dx = (fc.DX_KERNEL[name], "dx", fc.output_shape(name, shape, o), shape[-1], False,
                  name, shape)
            x.register_hook(lambda g: calls.append(dx))

    hooks = []
    for mod in model.modules():
        if isinstance(mod, blocks.Conv3x3):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args: site("fused_conv3x3_bn_relu", args[0], m.kernel.shape[-1],
                                     False)))
        if isinstance(mod, (blocks.DownBlock, blocks.UpBlock)):
            # the tail conv's input is the output of the block's 3x3 conv
            hooks.append(mod.conv.register_forward_hook(
                lambda m, args, out, blk=mod: site(
                    blk._kernel, out, getattr(blk, blk._tail_name).kernel.shape[-1],
                    not blk.training)))
    return hooks


def conv_counts(fc):
    """Launches of the three per-layer conv kernels on a path that runs with
    the chain off, where the chain kernel must not have launched."""
    counts = dict(fc.launches)
    if counts.pop(fc.CHAIN) != 0:
        raise AssertionError("the chain kernel launched on a path with the chain off")
    return counts


def counts_by_role(calls):
    out = {}
    for c in calls:
        out[(c[0], c[1])] = out.get((c[0], c[1]), 0) + 1
    return out


def row_shapes(cfg, batch):
    """(name, B, D) of the four row reductions of one Cond_SRVAE loss."""
    g = cfg.patch_size // 8
    return [("sq_rows", batch, cfg.patch_size ** 2 * cfg.channels),
            ("sq_rows", batch, cfg.lr_patch_size ** 2 * cfg.channels),
            ("kl_std_rows", batch, g * g * cfg.u_channels),
            ("kl_gen_rows", batch, g * g * cfg.z_channels)]


def profiled_device_ms(fn, reps: int, match):
    """Device time per call of the kernels (and memsets) whose name holds
    ``match`` (a string, or a tuple of them), from ``torch.profiler`` (for
    kernels shorter than their wrapper's host time, which CUDA events around
    a loop of calls measure instead); None when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    match = (match,) if isinstance(match, str) else match
    us = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages()
             if any(m in e.key for m in match))
    return us / reps / 1e3 if us else None


def check_rows(fe, name, b, d, seed):
    """Row kernel vs plain version at one shape, timed."""
    n_in = fe.MODES[name][1]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = [torch.randn((b, d), generator=gen, device="cuda") if i % 2 == 0
            else torch.rand((b, d), generator=gen, device="cuda") * 6 - 3 for i in range(n_in)]
    got = getattr(fe, name)(*rows)
    want = fe.PLAIN[name](*rows)
    torch.cuda.synchronize()
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    if not err <= ROW_TOL * ref:
        raise AssertionError(f"{name} ({b}, {d}): max|diff| {err} > {ROW_TOL} * {ref}")
    if not torch.equal(getattr(fe, name)(*rows), got):
        raise AssertionError(f"{name} ({b}, {d}): sums differ between two runs")
    nbytes = 4.0 * (n_in * b * d + b)
    flops = float(ROW_OPS[name] * b * d)
    return {"name": name, "x": [b, d], "max_abs_err": err, "max_abs_ref": ref,
            "ms": cuda_ms(lambda: getattr(fe, name)(*rows), 50),
            "plain_ms": cuda_ms(lambda: fe.PLAIN[name](*rows), 50),
            "device_ms": profiled_device_ms(lambda: getattr(fe, name)(*rows), 20, "rows_"),
            "library_ms": None, "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES),
            "bound_by": "operations" if flops / PEAK_F32_FLOPS > nbytes / PEAK_BYTES else "bytes"}


def time_weight_grad(fc, site, shape, o, seed):
    """The library weight-gradient call of conv ``site`` at one shape, timed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if site == "fused_conv3x3_bn_relu" else 4
    x = torch.randn(shape, generator=gen, device="cuda")
    g = torch.randn(fc.output_shape(site, shape, o), generator=gen, device="cuda")
    kernel = torch.randn((k, k, shape[-1], o), generator=gen, device="cuda")
    # TF32 off: on the first 2 images (sums short enough that float32's own
    # rounding stays near 1e-6 of the largest value) against float64; TF32's
    # 10-bit mantissa would miss by ~1e-3 whatever the sum's length
    dk = fc.weight_grad(site, x[:2], g[:2], kernel)
    want = fc.weight_grad(site, x[:2].double(), g[:2].double(), kernel.double())
    err = float((dk.double() - want).abs().max() / want.abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"library weight gradient {site} {shape}: {err} of max vs float64")
    m, n, kk, phases = fc.geometry(site, x, kernel)
    flops = 2.0 * phases * m * n * kk
    nbytes = 4.0 * (x.numel() + g.numel() + kernel.numel())
    return {"site": site, "x": list(shape), "o": o, "rel_err_vs_float64": err,
            "ms": cuda_ms(lambda: fc.weight_grad(site, x, g, kernel), 5),
            "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)}


def block_of(name: str) -> str:
    """The block (top-level module; below ``core`` for an SRVAE) of a parameter."""
    parts = name.split(".")
    return parts[1] if parts[0] == "core" and len(parts) > 1 else parts[0]


def kernels_vs_plain(make_model, init_state, batch, label="train step", chain=False,
                     train_cfg=None, tols=None, noise_model=None):
    """Phase 8: one train step and one val step from the same state, batch and
    noise, through the kernels and through the plain path; a third copy takes
    the plain step on the batch permuted (the same function, summed in
    another order), which measures float32's own noise in each gradient.
    ``make_model()`` builds the model on the card; with ``chain`` both
    copies' val steps run their conv tails through the chain. ``train_cfg``
    adds TrainConfig fields; ``tols`` replaces the float32 tolerances
    (``BF16_STEP_TOLS`` for a bfloat16 model). With ``noise_model`` (a
    bfloat16 model's float32 twin) the third copy is that model on the plain
    path and the same batch: the gradient's own bfloat16 error stands in for
    the permuted batch's float32 noise."""
    from simple_vae_rs_tpu_torch import TrainConfig, Trainer
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    n = batch[0].shape[0]
    tols = tols or {"terms": TERMS_TOL, "stats": STATS_TOL, "grad": GRAD_TOL,
                    "noise": NOISE_FACTOR, "params_share": 0.99}

    def copy_trainer(plain):
        m = make_model()
        m.load_state_dict(init_state)
        blocks.use_plain_path(m, plain)
        blocks.use_chain(m, chain)
        return Trainer(m, TrainConfig(learning_rate=LR, **(train_cfg or {})), device="cuda")

    def counts():
        return (dict(fc.launches), dict(fe.launches),
                {k: dict(v) for k, v in fc.bf16_launches.items()})

    tk, tp = copy_trainer(False), copy_trainer(True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    eps = tk.noise(n, tk._batch(batch)[0].shape[1:3], gen)
    grads_k, terms_k = tk.grads_and_terms(batch, eps)
    tk.apply_grads(grads_k, LR)
    torch.cuda.synchronize()
    before = counts()
    grads_p, terms_p = tp.grads_and_terms(batch, eps)
    tp.apply_grads(grads_p, LR)
    if noise_model is None:
        perm = torch.randperm(n, generator=gen, device="cuda")
        grads_q, _ = copy_trainer(True).grads_and_terms(tuple(t[perm] for t in batch),
                                                        tuple(e[perm] for e in eps))
    else:
        m = noise_model()
        m.load_state_dict(init_state)
        blocks.use_plain_path(m)
        tq = Trainer(m, TrainConfig(learning_rate=LR), device="cuda")
        grads_q, _ = tq.grads_and_terms(batch, eps)
        tq.apply_grads(grads_q, LR)
    torch.cuda.synchronize()
    if counts() != before:
        raise AssertionError("the plain training path launched a kernel")
    failures = []
    cmp = {"terms": {}, "grads": {}}
    for key, v in terms_p.items():
        rel = abs(float(terms_k[key] - v)) / max(abs(float(v)), 1e-30)
        cmp["terms"][key] = rel
        if not rel <= tols["terms"]:
            failures.append(f"train step {key}: relative diff {rel} > {tols['terms']}")
    block_max = {}
    for name, g in grads_p.items():
        blk = block_of(name)
        block_max[blk] = max(block_max.get(blk, 0.0), float(g.abs().max()))
    for name, g in grads_p.items():
        err = float((grads_k[name] - g).abs().max())
        noise = float((grads_q[name] - g).abs().max())
        cmp["grads"][name] = {
            "max_abs_err": err, "perm_noise": noise, "leaf_max": float(g.abs().max()),
            "of_block_max": err / max(block_max[block_of(name)], 1e-30),
            "of_leaf_max": err / max(float(g.abs().max()), 1e-30)}
        cmp["grads"][name]["of_noise"] = err / max(noise, 1e-30)
        limit = tols["noise"] * noise + tols["grad"] * block_max[block_of(name)]
        if not err <= limit:
            failures.append(f"grad {name}: max|diff| {err} > {tols['noise']} * {noise} "
                            f"(permuted-batch noise) + {tols['grad']} of its block's max")
    log("gradient leaves, worst 15 of block max: leaf, kernels-vs-plain max|diff|, "
        + ("permuted-plain-vs-plain" if noise_model is None else "float32-plain-vs-plain")
        + " max|diff|, leaf max, block max")
    for name, c in sorted(cmp["grads"].items(), key=lambda kv: -kv[1]["of_block_max"])[:15]:
        log(f"  {name}: {c['max_abs_err']:.3e} {c['perm_noise']:.3e} {c['leaf_max']:.3e} "
            f"{block_max[block_of(name)]:.3e}")
    worst_stat = 0.0
    for (name, buf), buf_p in zip(tk.model.named_buffers(), tp.model.buffers()):
        rel = float((buf - buf_p).abs().max()) / max(float(buf_p.abs().max()), 1e-30)
        worst_stat = max(worst_stat, rel)
        if not rel <= tols["stats"]:
            failures.append(f"BatchNorm statistic {name}: relative diff {rel}")
    diffs = torch.cat([(p - tp.params[name]).detach().abs().flatten()
                       for name, p in tk.params.items()])
    max_dp = float(diffs.max())
    share_close = float((diffs <= 1e-2 * LR).float().mean())
    want_share = tols["params_share"]
    if noise_model is not None:  # the share the float32 step keeps from the plain step
        noise_diffs = torch.cat([(p - tp.params[name]).detach().abs().flatten()
                                 for name, p in tq.params.items()])
        want_share = float((noise_diffs <= 1e-2 * LR).float().mean())
        cmp["param_share_float32_vs_plain"] = want_share
    if not (max_dp <= 2 * LR * (1 + 1e-3) and share_close >= want_share):
        failures.append(f"parameters after the step: max|diff| {max_dp}, "
                        f"{share_close:.4f} within 1e-2 * lr")
    chain_before = fc.launches[fc.CHAIN]
    vk = tk.val_step(batch)
    cmp["val_chain_launches"] = fc.launches[fc.CHAIN] - chain_before
    vp = tp.val_step(batch)
    if fc.launches[fc.CHAIN] - chain_before != cmp["val_chain_launches"]:
        raise AssertionError("the plain val step launched the chain kernel")
    cmp["val_terms"] = {}
    for key, v in vp.items():
        rel = abs(float(vk[key] - v)) / max(abs(float(v)), 1e-30)
        cmp["val_terms"][key] = rel
        if not rel <= tols["terms"]:
            failures.append(f"val step {key}: relative diff {rel} > {tols['terms']}")
    worst = max((c["of_block_max"], name) for name, c in cmp["grads"].items())
    worst_noise = max((c["of_noise"], name) for name, c in cmp["grads"].items())
    cmp.update({"worst_grad_of_block": worst, "worst_grad_of_noise": worst_noise,
                "worst_stat_rel": worst_stat,
                "param_max_abs_diff": max_dp, "param_share_within_1e-2_lr": share_close,
                "failures": failures})
    log(f"{label} kernels vs plain path: terms rel {max(cmp['terms'].values()):.2e}, "
        f"grads worst {worst[0]:.2e} of block max ({worst[1]}), worst {worst_noise[0]:.2f}x "
        f"the {'permuted-batch noise' if noise_model is None else 'float32-vs-bf16 error'} "
        f"({worst_noise[1]}), BN stats rel "
        f"{worst_stat:.2e}, params max|diff| {max_dp:.3e} ({share_close:.4f} within 1e-2 lr), "
        f"val terms rel {max(cmp['val_terms'].values()):.2e} (chain launches in the val step: "
        f"{cmp['val_chain_launches']})")
    return cmp


def training_batch(seed: int = 0):
    """512 (LR 32x32x4, HR 64x64x4) pairs cut on the card by the port's
    ``grid_sr_batch`` from 32 synthetic tiles (values x1000, numpy ``seed``)."""
    from simple_vae_rs_tpu_torch import grid_sr_batch

    rng = np.random.default_rng(seed)
    lr_tiles = torch.from_numpy(rng.random((32, 128, 128, 4), dtype=np.float32) * 1000).cuda()
    hr_tiles = torch.from_numpy(rng.random((32, 256, 256, 4), dtype=np.float32) * 1000).cuda()
    y, x = grid_sr_batch(lr_tiles, hr_tiles, 64)
    if tuple(y.shape) != (512, 32, 32, 4) or tuple(x.shape) != (512, 64, 64, 4):
        raise AssertionError(f"grid_sr_batch gave {tuple(y.shape)}, {tuple(x.shape)}")
    return y, x


def train_phase(report):
    """Phases 6-8; returns per-kernel totals over one train step and one val
    step, and each kernel's launches by path and role."""
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, TrainConfig, Trainer
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    def reset():
        fc.reset_launches()
        fe.reset_launches()

    # 6. set-up, the counted steps, the timed steps
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
    init_state = copy.deepcopy(model.state_dict())
    batch = training_batch()
    y, x = batch
    n = y.shape[0]
    trainer = Trainer(model, TrainConfig(learning_rate=LR), device="cuda")

    train_calls, val_calls = [], []
    hooks = record_conv_calls(model, train_calls)
    reset()
    terms0 = trainer.train_step(batch)
    torch.cuda.synchronize()
    step_roles = {k: dict(v) for k, v in fc.role_launches.items()}
    step_rows = dict(fe.launches)
    for h in hooks:
        h.remove()
    hooks = record_conv_calls(model, val_calls)
    reset()
    val0 = trainer.val_step(batch)
    torch.cuda.synchronize()
    val_convs, val_rows = conv_counts(fc), dict(fe.launches)
    for h in hooks:
        h.remove()
    for what, terms in (("train", terms0), ("val", val0)):
        if not all(torch.isfinite(v) for v in terms.values()):
            raise AssertionError(f"{what} step: non-finite loss terms {terms}")

    recorded = counts_by_role(train_calls)
    roles_line = []
    for name, roles in step_roles.items():
        for role, count in roles.items():
            if count <= 0 or recorded.get((name, role), 0) != count:
                raise AssertionError(f"train step: {name} {role} launched {count} times, "
                                     f"hooks recorded {recorded.get((name, role), 0)}")
        roles_line.append(f"{name} forward={roles['forward']} dx={roles['dx']} "
                          f"total={sum(roles.values())}")
    recorded_val = counts_by_role(val_calls)
    for name, count in val_convs.items():
        if count <= 0 or recorded_val.get((name, "forward"), 0) != count:
            raise AssertionError(f"val step: {name} launched {count} times, hooks recorded "
                                 f"{recorded_val.get((name, 'forward'), 0)}")
    want_rows = {"sq_rows": 2, "kl_std_rows": 1, "kl_gen_rows": 1}
    if step_rows != want_rows or val_rows != want_rows:
        raise AssertionError(f"row kernels launched {step_rows} (train), {val_rows} (val)")
    log("train step launches: " + " | ".join(roles_line) + " | "
        + " ".join(f"{k}={v}" for k, v in step_rows.items()))
    log("val step launches: " + " ".join(f"{k}={v}" for k, v in val_convs.items()) + " "
        + " ".join(f"{k}={v}" for k, v in val_rows.items()))

    timed(lambda: trainer.train_step(batch))  # second warm-up step
    torch.cuda.reset_peak_memory_stats()
    step_ms = [timed(lambda: trainer.train_step(batch))[1] for _ in range(5)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    val_ms = [timed(lambda: trainer.val_step(batch))[1] for _ in range(3)]
    med = statistics.median(step_ms)
    log(f"train step B={n}: median {med:.2f} ms over 5 ({', '.join(f'{t:.2f}' for t in step_ms)}),"
        f" {n / (med / 1e3):.1f} patches/s, peak memory {peak_gib:.2f} GiB; "
        f"val step median {statistics.median(val_ms):.2f} ms")
    del trainer, model

    # 7. every distinct training shape, by kernel and role: check and time
    def key_of(call):
        name, role, shape, o, relu, site, _ = call
        return name, role, shape, o, relu, site if role == "dx" else None

    per_key = {}
    for i, call in enumerate(sorted(set(train_calls + val_calls), key=str)):
        name, role, shape, o, relu, site = key = key_of(call)
        if key in per_key:
            continue
        per_key[key] = row = check_shape(fc, name, shape, o, relu, seed=300 + i, timing=True,
                                         site=site)
        log(f"train shape {name} {role} x{shape} O={o} relu={relu}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), 3xTF32 bound {row['bound_tc_ms']:.4f} ms, CUDA-core bound "
            f"{row['bound_cuda_core_ms']:.4f} ms, max|diff| {row['max_abs_err']:.2e}")
    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms", "bound_cuda_core_ms",
              "flops", "bytes")
    by_role = {}
    for path, path_calls in (("train_step", train_calls), ("val_step", val_calls)):
        for call in path_calls:
            row = per_key[key_of(call)]
            d = by_role.setdefault((path, call[0], call[1]),
                                   dict.fromkeys(("launches",) + fields, 0.0))
            d["launches"] += 1
            for k in fields:
                d[k] += row[k]
    totals = {}
    for (path, name, role), d in by_role.items():
        log(f"{path} {name} {role}: launches {int(d['launches'])}, kernel {d['ms']:.3f} ms, "
            f"bound {d['bound_ms']:.3f} ms, 3xTF32 bound {d['bound_tc_ms']:.3f} ms, CUDA-core "
            f"bound {d['bound_cuda_core_ms']:.3f} ms, plain {d['plain_ms']:.3f} ms, library "
            f"{d['library_ms']:.3f} ms")
        tot = totals.setdefault(name, dict.fromkeys(fields + ("max_abs_err",), 0.0))
        for k in fields:
            tot[k] += d[k]
    for row in per_key.values():
        totals[row["name"]]["max_abs_err"] = max(totals[row["name"]]["max_abs_err"],
                                                 row["max_abs_err"])
    conv_ms = {name: sum(d["ms"] for (path, n, _), d in by_role.items()
                         if path == "train_step" and n == name) for name in totals}
    rows = list(per_key.values())
    rows_ms = 0.0
    for i, (name, b, d) in enumerate(row_shapes(cfg, n)):
        row = check_rows(fe, name, b, d, seed=400 + i)
        rows.append(row)
        tot = totals.setdefault(name, dict.fromkeys(fields + ("max_abs_err",), 0.0))
        for k in ("ms", "plain_ms", "bound_ms", "flops", "bytes"):
            tot[k] += 2 * row[k]  # once in the train step, once in the val step
        tot["library_ms"] = None
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        rows_ms += row["ms"]
        log(f"train rows {name} ({b}, {d}): kernel {row['ms']:.4f} ms (profiler device time "
            f"{row['device_ms']} ms), plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), max|diff| {row['max_abs_err']:.2e}")
    dk_rows = {}
    for call in train_calls:
        name, role, shape, o, relu, site, site_shape = call
        if role == "forward":
            key = (site, site_shape, o)
            if key not in dk_rows:
                dk_rows[key] = dict(time_weight_grad(fc, site, site_shape, o, 500 + len(dk_rows)),
                                    launches=0)
            dk_rows[key]["launches"] += 1
    dk_ms = sum(r["ms"] * r["launches"] for r in dk_rows.values())
    dk_bound = sum(r["bound_ms"] * r["launches"] for r in dk_rows.values())
    log(f"train step {med:.2f} ms: conv kernels {sum(conv_ms.values()):.2f} ms "
        f"({100 * sum(conv_ms.values()) / med:.1f}%: "
        + ", ".join(f"{k} {v:.2f}" for k, v in conv_ms.items())
        + f"), library weight gradients {dk_ms:.2f} ms ({100 * dk_ms / med:.1f}%, "
        f"{sum(r['launches'] for r in dk_rows.values())} calls, bound {dk_bound:.2f} ms), "
        f"row kernels {rows_ms:.3f} ms ({100 * rows_ms / med:.2f}%); the rest is BatchNorm, "
        f"elementwise ops, the optimizer, launches and host time")
    # 8. kernels vs the plain path
    cmp = kernels_vs_plain(lambda: CondSRVAE(cfg, device="cuda"), init_state, batch)
    report["training"] = {
        "batch": n, "step_ms": step_ms, "step_ms_median": med,
        "patches_per_s": n / (med / 1e3), "peak_memory_gib": peak_gib, "val_step_ms": val_ms,
        "launches_train_step": step_roles, "rows_train_step": step_rows,
        "launches_val_step": val_convs, "rows_val_step": val_rows,
        "kernels_vs_plain": cmp, "shapes": rows,
        "by_role": {" ".join(k): v for k, v in by_role.items()},
        "weight_grads": [dict(r, site_shape=list(k[1])) for k, r in dk_rows.items()],
        "step_share_ms": {"conv_kernels": conv_ms, "weight_grads": dk_ms, "rows": rows_ms},
    }
    launches_by = {}
    for name, roles in step_roles.items():
        launches_by[name] = {"train_step_forward": roles["forward"], "train_step_dx": roles["dx"],
                             "val_step": val_convs[name]}
    for name in ROW_OPS:
        launches_by[name] = {"train_step": step_rows[name], "val_step": val_rows[name]}
    if cmp["failures"]:
        raise AssertionError("kernels vs plain path: " + "; ".join(cmp["failures"]))
    return totals, launches_by

# ------------------------------------------------------------ the training run
FIT_TRAIN_SEEDS, FIT_VAL_SEEDS = (10, 11, 12), (13,)  # batches of 512 pairs each


class RecordLogger:
    """Keeps every logged record (step, metrics) in memory."""

    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append((step, {k: float(v) for k, v in metrics.items()}))

    def log_images(self, images, step=None):
        pass

    def finish(self):
        pass


def path_counts(fc, fe):
    """The float32 launches by kernel and role, and the row kernels'."""
    out = {f"{name} {role}": n for name, roles in fc.role_launches.items()
           for role, n in roles.items()}
    out.update(fe.launches)
    out[fc.CHAIN] = fc.launches[fc.CHAIN]
    return out


def reset_path_counts(fc, fe):
    fc.reset_launches()
    fe.reset_launches()


def fit_phase(report, card):
    """Phase F: the training run end to end on the canonical Cond_SRVAE at
    full width (F1-F4) and in bfloat16 (F5); returns the report's "fit"
    entry. No check's failure is caught."""
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, SuperResolver, TrainConfig
    from simple_vae_rs_tpu_torch import Trainer
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe
    from simple_vae_rs_tpu_torch.train import engine
    from simple_vae_rs_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
    from simple_vae_rs_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from simple_vae_rs_tpu_torch.train.state import make_optimizer
    from simple_vae_rs_tpu_torch.utils.logging import JsonlLogger

    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    train = [training_batch(s) for s in FIT_TRAIN_SEEDS]
    val = [training_batch(s) for s in FIT_VAL_SEEDS]
    out = {"card": card}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fit_", dir=os.path.join(ROOT, "build"))
    try:
        # F1. the launches of one step of each kind the run takes, on a probe
        probe = Trainer(CondSRVAE(cfg, device="cuda").init_weights(1),
                        TrainConfig(learning_rate=LR), device="cuda")
        per_step = {}
        for kind, run in (
                ("pretrain", lambda: probe.pretrain_step(
                    train[0], make_optimizer(probe.cfg, list(probe.params.values())), LR)),
                ("train", lambda: probe.train_step(train[0])),
                ("val", lambda: probe.val_step(val[0])),
                ("metrics", lambda: probe.eval_metrics_step(val[0])),
                ("images", lambda: probe.eval_images_step(val[0]))):
            reset_path_counts(fc, fe)
            run()
            torch.cuda.synchronize()
            per_step[kind] = path_counts(fc, fe)
        del probe
        torch.cuda.empty_cache()
        log("fit per-step launches: " + " | ".join(
            f"{kind}: " + " ".join(f"{k}={v}" for k, v in c.items() if v)
            for kind, c in per_step.items()))

        # F1. pre-training 1 pre-epoch, then fit 2 epochs, full evaluation each
        mc = ModelCheckpoint("job", tmp, monitor="Loss/val_loss")
        snapshots = {}

        class Snapshot:
            """The model state at the epoch ModelCheckpoint saved."""

            def on_epoch_begin(self, **kw):
                return False

            def on_epoch_end(self, **kw):
                if mc.best_epoch == kw["epoch"]:
                    snapshots["best"] = {k: v.clone() for k, v in kw["model"].state_dict().items()}
                return False

        run_dir = os.path.join(tmp, "run")
        trainer = Trainer(CondSRVAE(cfg, device="cuda").init_weights(0),
                          TrainConfig(learning_rate=LR, val_metrics_every=1), device="cuda",
                          callbacks=[mc, EarlyStopping(patience=25, delta=0.01), Snapshot()],
                          logger=JsonlLogger(run_dir), job_id="job")
        reset_path_counts(fc, fe)
        torch.cuda.reset_peak_memory_stats()
        _, pre_ms = timed(lambda: trainer.pretrain_lr_branch(train, 1))
        _, fit_ms = timed(lambda: trainer.fit(train, val, epochs=2, val_metrics_every=1))
        fit_peak = torch.cuda.max_memory_allocated() / 2**30
        got = path_counts(fc, fe)
        lpips_on = trainer._lpips_params is not None
        n = {"pretrain": len(train), "train": 2 * len(train), "val": 2 * len(val),
             "metrics": 2 * len(val), "images": 2 * len(val) if lpips_on else 1}
        want = {k: sum(n[kind] * per_step[kind][k] for kind in n) for k in got}
        if got != want or got[fc.CHAIN]:
            raise AssertionError(f"fit launches {got}, expected {want} (steps {n})")
        for k in ("fused_conv3x3_bn_relu forward", "fused_conv3x3_bn_relu dx",
                  "fused_conv4x4s2_bn_relu forward", "fused_conv4x4s2_bn_relu dx",
                  "fused_convT4x4s2_bn_relu forward", "fused_convT4x4s2_bn_relu dx",
                  "sq_rows", "kl_std_rows", "kl_gen_rows"):
            if got[k] <= 0:
                raise AssertionError(f"the training run launched {k} no time")
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        keys = {k for r in records for k in r} - {"_step", "_time"}
        want_keys = set(engine.FIT_KEYS["cond"]) | {engine.PRETRAIN_KEY}
        if lpips_on:
            want_keys |= set(engine.LPIPS_KEYS["cond"])
        if keys != want_keys:
            raise AssertionError(f"logged keys {sorted(keys ^ want_keys)} differ from the JAX "
                                 "fit's")
        losses = {(r["_step"], k): v for r in records for k, v in r.items()
                  if k.startswith("Loss/")}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"non-finite losses {losses}")
        epoch_s = [r["Perf/train_epoch_seconds"] for r in records
                   if "Perf/train_epoch_seconds" in r]
        final = {k: v for r in records if r["_step"] == 2 for k, v in r.items()
                 if k.startswith(("Loss/", "Metrics/"))}
        log(f"F1 fit launches (pre-training 3 steps, 6 train, 2 val, 2 metrics, "
            f"{n['images']} image steps): " + " ".join(f"{k}={v}" for k, v in got.items() if v)
            + "; equal to the per-step counts times the steps")
        log(f"F1 pre-training 1 epoch {pre_ms:.1f} ms; fit 2 epochs {fit_ms:.1f} ms "
            f"(train epochs {', '.join(f'{1e3 * t:.1f}' for t in epoch_s)} ms, 3 steps of 512 "
            f"each; with the baseline, val, evaluation and best-only checkpoints); peak memory "
            f"{fit_peak:.2f} GiB; LPIPS {'on' if lpips_on else 'off (no weights on disk)'}; "
            f"logged keys = the JAX fit's ({len(keys)}); best epoch {mc.best_epoch}; "
            f"card {card}")
        log("F1 epoch 2: " + " ".join(f"{k}={v:.6g}" for k, v in sorted(final.items())))
        out.update({"per_step_launches": per_step, "fit_launches": got, "steps": n,
                    "pretrain_ms": pre_ms, "fit_ms": fit_ms, "train_epoch_seconds": epoch_s,
                    "fit_peak_memory_gib": fit_peak, "epoch2": final,
                    "best_epoch": mc.best_epoch})

        # F2. the best checkpoint served, against the model it was saved from
        best = os.path.join(tmp, "job")
        y = np.random.default_rng(2).random((16, 32, 32, 4), dtype=np.float32)
        sr_c, build_ms = timed(lambda: SuperResolver.from_checkpoint(best, seed=0,
                                                                         device="cuda"))
        mem = CondSRVAE(cfg, device="cuda")
        mem.load_state_dict(snapshots["best"])
        sr_m = SuperResolver(mem, seed=0, device="cuda")
        uq_c = sr_c.uncertainty(y[0], samples=1000, seed=12)
        uq_m = sr_m.uncertainty(y[0], samples=1000, seed=12)
        for what, a, b in (("super_resolve B=16", sr_c.super_resolve(y, seed=11),
                            sr_m.super_resolve(y, seed=11)),
                           ("uncertainty N=1000 mean", uq_c["mean"], uq_m["mean"]),
                           ("uncertainty N=1000 std", uq_c["std"], uq_m["std"])):
            if not torch.equal(a, b):
                raise AssertionError(f"F2 {what}: from_checkpoint differs from the in-memory "
                                     f"model (max|diff| {float((a - b).abs().max())})")
        sr8, build8_ms = timed(lambda: SuperResolver.from_checkpoint(best, seed=0, int8=True,
                                                                           device="cuda"))
        ref = sr_c.super_resolve(y, seed=11)
        db = psnr_db(sr8.super_resolve(y, seed=11), ref)
        db_uq = psnr_db(sr8.uncertainty(y[0], samples=1000, seed=12)["mean"], uq_c["mean"])
        if not (db > MIN_PSNR_DB and db_uq > MIN_PSNR_DB):
            raise AssertionError(f"F2 int8 from_checkpoint: {db:.2f} / {db_uq:.2f} dB")
        log(f"F2 from_checkpoint(best, epoch {mc.best_epoch}): build {build_ms:.1f} ms "
            f"(int8 {build8_ms:.1f} ms); super_resolve B=16 and uncertainty N=1000 the same "
            f"bits as the in-memory model; int8 {db:.2f} dB / {db_uq:.2f} dB against it "
            f"(served f32 output mean {float(ref.mean()):.4f}, std {float(ref.std()):.4f}, "
            f"min {float(ref.min()):.4f}, max {float(ref.max()):.4f}); card {card}")
        out.update({"from_checkpoint_ms": build_ms, "from_checkpoint_int8_ms": build8_ms,
                    "int8_psnr_db": [db, db_uq]})
        del sr_c, sr_m, sr8, mem, trainer, snapshots
        torch.cuda.empty_cache()

        # F3. resume: epoch 2 in a fresh trainer loaded from epoch 1's
        # checkpoint against the trainer that goes on; cuDNN's weight
        # gradients held deterministic, so the two must agree to the bit
        tcfg = TrainConfig(learning_rate=LR)
        ta = Trainer(CondSRVAE(cfg, device="cuda").init_weights(2), tcfg, device="cuda",
                     logger=(log_a := RecordLogger()))
        ta.fit(train, val, epochs=1, val_metrics_every=1)
        path = os.path.join(tmp, "resume")
        extra = {"scheduler": ta.scheduler.state_dict(), "model": ta._model_meta()}
        _, save_ms = timed(lambda: save_checkpoint(path, ta, epoch=1, extra=extra))
        tb = Trainer(CondSRVAE(cfg, device="cuda"), tcfg, device="cuda",
                     logger=(log_b := RecordLogger()))
        meta, load_ms = timed(lambda: load_checkpoint(path, tb))
        size_mb = os.path.getsize(path + ".pt") / 2**20
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            ta.fit(train, val, epochs=2, start_epoch=2, val_metrics_every=1)
            tb.fit(train, val, epochs=2, start_epoch=meta["epoch"] + 1, val_metrics_every=1)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        sa, sb = ta.model.state_dict(), tb.model.state_dict()
        bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
        bad += [f"opt.{key}[{i}]" for key in ("mu", "nu")
                for i, (a, b) in enumerate(zip(getattr(ta.opt, key), getattr(tb.opt, key)))
                if not torch.equal(a, b)]

        def epoch2(logger):
            return {k: v for s, m in logger.records if s == 2 for k, v in m.items()
                    if k != "Perf/train_epoch_seconds"}

        if bad or epoch2(log_a) != epoch2(log_b) or ta.step != tb.step:
            raise AssertionError(f"F3 resume differs: {bad[:10]}, logs "
                                 f"{epoch2(log_a)} vs {epoch2(log_b)}")
        log(f"F3 resume: save {save_ms:.1f} ms, load {load_ms:.1f} ms ({size_mb:.1f} MiB: "
            f"parameters, statistics, both moments, generator); epoch 2 resumed the same bits "
            f"as epoch 2 continued (parameters, statistics, moments, logged metrics; "
            f"cudnn.deterministic for both); card {card}")
        out.update({"save_ms": save_ms, "load_ms": load_ms, "checkpoint_mib": size_mb})
        del ta, tb
        torch.cuda.empty_cache()

        # F4. one step with remat against one without, from one state and noise
        init = CondSRVAE(cfg, device="cuda").init_weights(3).state_dict()
        steps = {}
        eps = None
        for label, remat, perm in (("plain", False, None), ("remat", True, None),
                                   ("permuted", False, True)):
            m = CondSRVAE(cfg, device="cuda")
            m.load_state_dict(init)
            t = Trainer(m, TrainConfig(learning_rate=LR, remat=remat), device="cuda")
            if eps is None:
                eps = t.noise(512, (32, 32), torch.Generator(device="cuda").manual_seed(6))
                order = torch.randperm(512, generator=torch.Generator(device="cuda")
                                       .manual_seed(7), device="cuda")
            batch, noise = train[0], eps
            if perm:
                batch, noise = tuple(b[order] for b in batch), tuple(e[order] for e in eps)
            reset_path_counts(fc, fe)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            grads, terms = t.grads_and_terms(batch, noise)
            torch.cuda.synchronize()
            steps[label] = (grads, terms, {k: v.clone() for k, v in m.named_buffers()},
                            path_counts(fc, fe), torch.cuda.max_memory_allocated() / 2**30)
            del m, t
        (g0, t0, s0, c0, p0), (g1, t1, s1, c1, p1), (gq, *_) = (
            steps["plain"], steps["remat"], steps["permuted"])
        for k, v in c0.items():
            role = k.split(" ")[-1]
            want_k = 2 * v if role == "forward" else v
            if k.startswith("fused_") and c1[k] != want_k:
                raise AssertionError(f"F4 remat launches {k}: {c1[k]}, expected {want_k}")
        bad_stats = [k for k in s0 if not torch.equal(s0[k], s1[k])]
        if bad_stats:
            raise AssertionError(f"F4 remat BatchNorm statistics differ: {bad_stats[:5]}")
        block_max = {}
        for name, g in g0.items():
            block_max[block_of(name)] = max(block_max.get(block_of(name), 0.0),
                                            float(g.abs().max()))
        worst = 0.0
        for name, g in g0.items():
            err = float((g1[name] - g).abs().max())
            limit = NOISE_FACTOR * float((gq[name] - g).abs().max()) \
                + GRAD_TOL * block_max[block_of(name)]
            if not err <= limit:
                raise AssertionError(f"F4 remat gradient {name}: {err} > {limit}")
            worst = max(worst, err)
        for key, v in t0.items():
            if abs(float(t1[key] - v)) > TERMS_TOL * abs(float(v)):
                raise AssertionError(f"F4 remat loss term {key}: {float(t1[key])} vs {float(v)}")
        log(f"F4 remat step B=512: conv launches forward x2 ("
            + " ".join(f"{k}={c1[k]}" for k in c1 if k.startswith("fused_") and c1[k])
            + "), rows " + " ".join(f"{k}={c1[k]}/{c0[k]}" for k in ROW_OPS)
            + f" (remat/plain); gradients max|diff| {worst:.3e} within the {NOISE_FACTOR:g}x "
            f"float32 noise rule; BatchNorm statistics the same bits (updated once); peak "
            f"memory {p1:.2f} GiB with remat, {p0:.2f} GiB without; card {card}")
        out.update({"remat_launches": c1, "plain_launches": c0, "remat_peak_gib": p1,
                    "plain_peak_gib": p0, "remat_grad_max_abs_diff": worst})
        del steps, g0, g1, gq
        torch.cuda.empty_cache()

        # F5. bfloat16 with bf16 first moments: one epoch, save, load
        bcfg = TrainConfig(learning_rate=LR, use_bfloat16=True, bf16_moments=True)
        tbf = Trainer(CondSRVAE(cfg, device="cuda", dtype=torch.bfloat16).init_weights(4), bcfg,
                      device="cuda")
        _, bf_fit_ms = timed(lambda: tbf.fit(train, val, epochs=1, val_metrics_every=1))
        path = os.path.join(tmp, "bf16")
        _, bf_save_ms = timed(lambda: save_checkpoint(path, tbf, epoch=1))
        tld = Trainer(CondSRVAE(cfg, device="cuda", dtype=torch.bfloat16), bcfg, device="cuda")
        _, bf_load_ms = timed(lambda: load_checkpoint(path, tld))
        if not all(m.dtype == torch.bfloat16 for m in tld.opt.mu):
            raise AssertionError("F5: the first moment did not come back in bfloat16")
        pairs = list(zip(tbf.opt.mu + tbf.opt.nu, tld.opt.mu + tld.opt.nu))
        pairs += [(p, tld.params[k]) for k, p in tbf.params.items()]
        if not all(torch.equal(a, b) for a, b in pairs) or tld.step != tbf.step:
            raise AssertionError("F5: the loaded bfloat16 run differs from the saved one")
        log(f"F5 bf16 (bf16_moments) 1 epoch {bf_fit_ms:.1f} ms, save {bf_save_ms:.1f} ms "
            f"({os.path.getsize(path + '.pt') / 2**20:.1f} MiB), load {bf_load_ms:.1f} ms; mu "
            f"back in bfloat16, parameters and moments the same bits; card {card}")
        out.update({"bf16_fit_ms": bf_fit_ms, "bf16_save_ms": bf_save_ms,
                    "bf16_load_ms": bf_load_ms})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["fit"] = out
    return out


# ------------------------------------------------- training from tiles on disk
# the ARM-shaped tree and the CLI's flags: 160 tile pairs of HR 256 px, 128 of
# them train (4 steps of 32 tiles = 512 pairs of the canonical model), 32 val
G_TILES, G_HR, G_BATCH, G_PS, G_CR = 160, 256, 32, 64, 1.2


def write_arm_tree(root, n, seed):
    """An ARM-shaped tree of ``n`` tile pairs (HR G_HR px, LR half), int16
    digital numbers (the scenes of ``SyntheticHFDataset`` x1000, rounded),
    LZW with the predictor, interleaved, written with the port's
    ``write_tiff`` (``make_index`` writes its ``index.csv``). Returns the
    arrays written, the seconds the writes took (the scenes are rendered
    first, on every host core) and the rows its index must hold."""
    from concurrent.futures import ThreadPoolExecutor

    from simple_vae_rs_tpu_torch.data.datasets import SyntheticHFDataset
    from simple_vae_rs_tpu_torch.data.tiffio import write_tiff

    ds = SyntheticHFDataset(length=n, hr_size=G_HR, seed=seed)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        pairs = list(pool.map(lambda i: tuple(np.rint(a).astype(np.int16) for a in ds[i]),
                              range(n)))
    os.makedirs(root, exist_ok=True)
    rows = [["b2b3b4b8_10m", "b2b3b4b8_05m"]]
    t0 = time.perf_counter()
    for i, (lr, hr) in enumerate(pairs):
        write_tiff(os.path.join(root, f"S2_{i:04d}_10m.tif"), lr, compression="lzw",
                   predictor=True)
        write_tiff(os.path.join(root, f"S2_{i:04d}_05m.tif"), hr, compression="lzw",
                   predictor=True)
        rows.append([f"S2_{i:04d}_10m.tif", f"S2_{i:04d}_05m.tif"])
    return pairs, time.perf_counter() - t0, rows


def cli_flags(tree, *extra):
    return cli_args(["--dataset", "s2v", "--data_root", tree, "--crop", "grid",
                     "--batch_size", str(G_BATCH), "--patch_size", str(G_PS), "-cr", str(G_CR),
                     *extra])


def cli_args(argv):
    from simple_vae_rs_tpu_torch import cli

    return cli.parse_args(argv)


def run_cli(job, args):
    """``cli.main`` in-process under the job id ``job``; its result."""
    from simple_vae_rs_tpu_torch import cli

    os.environ["SLURM_JOB_ID"] = job
    return cli.main(args)


def run_records(job):
    """The metrics.jsonl records of the CLI run ``job`` (in the working
    directory's ``runs/``) and its run directory."""
    (name,) = [d for d in os.listdir("runs") if d.endswith(f"-SLURM-{job}")]
    with open(os.path.join("runs", name, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh], os.path.join("runs", name)


def main_output(fn):
    """Run ``fn`` with its standard output captured: (its result, the text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    text = buf.getvalue()
    sys.stdout.write(text)
    return result, text


def loader_epoch(trainer, batches, loader=None):
    """One train epoch over ``batches`` (an iterable of batches on the card),
    synchronized: its ms, and the loader's timings when it came from one."""
    torch.cuda.synchronize()
    if loader is not None:
        loader.timings(reset=True)
    t0 = time.perf_counter()
    n = 0
    for batch in batches:
        trainer.train_step(batch)
        n += 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, n, (loader.timings() if loader is not None else None)


def decode_split(tree, n, tiffio, lzw_native):
    """The files of one batch (tile pairs 0..n-1) decoded stage by stage on
    one thread, each stage timed over the whole batch: opening each file and
    reading its strip's bytes, the native LZW decode, the predictor's undo
    (``tiffio._undo_predictor``); then ``read_tiff`` whole over the same
    files. ms each, the MiB decoded, and the whole less the three stages."""
    paths = [os.path.join(tree, f"{k}_{i:04d}_{r}.tif") for i in range(n)
             for k, r in (("S2", "10m"), ("S2", "05m"))]
    t0 = time.perf_counter()
    raws = []
    for path in paths:
        with tiffio.TiffReader(path) as r:
            if len(r._offsets) != 1 or r.planar != 1:
                raise AssertionError(f"G1: {path} is not one interleaved strip")
            r._fh.seek(r._offsets[0])
            raws.append((r._fh.read(r._counts[0]), r.height, r.width, r.samples_per_pixel,
                         r._file_dtype))
    open_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    decoded = [lzw_native.lzw_decode_native(raw, h * w * c * dt.itemsize)
               for raw, h, w, c, dt in raws]
    lzw_ms = (time.perf_counter() - t0) * 1e3
    samples = [np.frombuffer(d, dt)[:h * w * c] for d, (_, h, w, c, dt) in zip(decoded, raws)]
    t0 = time.perf_counter()
    undone = [tiffio._undo_predictor(a, h, w, c) for a, (_, h, w, c, _) in zip(samples, raws)]
    undo_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    whole = [tiffio.read_tiff(path) for path in paths]
    whole_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(undone, whole):
        if not np.array_equal(a, b.reshape(-1)):
            raise AssertionError("G1: the stage-by-stage decode differs from read_tiff")
    mib = sum(b.nbytes for b in whole) / 2**20
    return {"files": len(paths), "mib": mib, "open_read_ms": open_ms, "lzw_ms": lzw_ms,
            "undo_ms": undo_ms, "read_tiff_ms": whole_ms,
            "rest_ms": whole_ms - open_ms - lzw_ms - undo_ms}


def gpu_busy_us(events, t0, t1):
    """The union of the card's kernels, copies and sets in a Chrome trace's
    events, clipped to [t0, t1], in microseconds."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, t0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def traced_epoch(trainer, batches, path):
    """One train epoch over ``batches`` under ``torch.profiler`` (host and
    card), its Chrome trace gzipped to ``path``; ``trace_stats`` of it."""
    import gzip

    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("g3_epoch"):
            for batch in batches:
                with record_function("g3_step"):
                    trainer.train_step(batch)
            torch.cuda.synchronize()
    raw = path[:-len(".gz")]
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as fh:
        data = fh.read()
    with gzip.open(path, "wb") as fh:
        fh.write(data)
    os.remove(raw)
    return trace_stats(json.loads(data)["traceEvents"], path)


def trace_stats(events, path):
    """From the Chrome trace of ``traced_epoch``: the epoch's ms on the
    host, the card's busy ms in it (kernels and copies) and its idle share;
    the host ms inside the steps, before the first step (the first batch),
    between the steps (the queue, the copy, the crop) and after the last
    (the closing synchronize); the host ms in operators on each thread (the
    outermost operators only; "main" runs the steps, the autograd engine's
    thread their backward); the five CUDA runtime calls that took the most
    host time."""
    def marks(name):
        return sorted((e["ts"], e["dur"], e["tid"]) for e in events
                      if e.get("name") == name and e.get("cat") == "user_annotation")

    ((t0, dur, _),) = marks("g3_epoch")
    steps = marks("g3_step")
    if not steps:
        raise AssertionError(f"G3 trace {path}: no step")
    busy = gpu_busy_us(events, t0, t0 + dur)
    if busy <= 0:
        raise AssertionError(f"G3 trace {path}: the card ran nothing")
    in_steps = sum(d for _, d, _ in steps)
    first = steps[0][0] - t0
    after = t0 + dur - (steps[-1][0] + steps[-1][1])
    main = steps[0][2]
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op" and "dur" in e and t0 <= e["ts"] <= t0 + dur:
            ops.setdefault("main" if e["tid"] == main else f"thread {e['tid']}", []).append(
                (e["ts"], e["dur"]))
    op_ms = {}
    for tid, spans in ops.items():
        total, end = 0.0, -math.inf
        for ts, d in sorted(spans):
            if ts >= end:  # an outermost operator
                total, end = total + d, ts + d
        op_ms[tid] = total / 1e3
    runtime = {}  # CUDA runtime calls on every host thread: ms and count by name
    for e in events:
        if e.get("cat") == "cuda_runtime" and "dur" in e and t0 <= e["ts"] <= t0 + dur:
            ms, n = runtime.get(e["name"], (0.0, 0))
            runtime[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return {"epoch_ms": dur / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / dur,
            "steps": len(steps), "in_steps_ms": in_steps / 1e3, "before_first_ms": first / 1e3,
            "between_ms": (dur - in_steps - first - after) / 1e3, "after_last_ms": after / 1e3,
            "op_ms_by_thread": dict(sorted(op_ms.items(), key=lambda kv: -kv[1])[:3]),
            "runtime_top": dict(sorted(runtime.items(), key=lambda kv: -kv[1][0])[:5])}


def cli_phase(report, card, tmp):
    """Phase G: ``python -m simple_vae_rs_tpu_torch.cli``'s ``main`` on an
    ARM-shaped tree on disk (G1-G5), ``evaluate`` (G6) and ``doctor`` (G7),
    all in the temporary directory ``tmp`` under ``build/`` (phase H reads
    its tree and checkpoint; the caller removes it). No check's failure is
    caught."""
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, SuperResolver, TrainConfig
    from simple_vae_rs_tpu_torch import Trainer, doctor
    from simple_vae_rs_tpu_torch import evaluate as ev
    from simple_vae_rs_tpu_torch.data import lzw_native, tiffio
    from simple_vae_rs_tpu_torch.data.loader import init_dataloader
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe
    from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
    from simple_vae_rs_tpu_torch.ops import quantize as qz
    from simple_vae_rs_tpu_torch.ops.patchify import grid_patchify, grid_unpatchify
    from simple_vae_rs_tpu_torch.tasks import run_task
    from simple_vae_rs_tpu_torch.train import engine
    from simple_vae_rs_tpu_torch.utils.tensorboard import read_tfevents

    out = {"card": card}
    cwd = os.getcwd()
    job_env = os.environ.get("SLURM_JOB_ID")
    os.chdir(tmp)  # the CLI writes ckpt/, runs/ and results/ where it runs
    try:
        # G1. the tree, read back, the native codec
        tree = os.path.join(tmp, "ARM")
        pairs, write_s, rows = write_arm_tree(tree, G_TILES, seed=5)
        # G0. make_index --validate writes the index phase G trains from
        from simple_vae_rs_tpu_torch import make_index

        with open(os.devnull, "w") as null:
            import contextlib

            with contextlib.redirect_stdout(null):
                t0 = time.perf_counter()
                rc = make_index.main([tree, "--validate"])
                index_s = time.perf_counter() - t0
        with open(os.path.join(tree, "index.csv"), newline="") as fh:
            import csv

            got_rows = list(csv.reader(fh, delimiter="\t"))
        if rc != 0 or got_rows != rows:
            raise AssertionError(f"G0 make_index --validate: exit {rc}, {len(got_rows)} rows, "
                                 f"expected the {len(rows)} written beside the tiles")
        log(f"G0 make_index --validate: {len(rows) - 1} pairs opened and checked, index.csv "
            f"= the rows the tree was written with, {index_s:.2f} s; card {card}")
        out["g0_index_s"] = index_s
        raw_mb = sum(a.nbytes + b.nbytes for a, b in pairs) / 2**20
        disk_mb = sum(os.path.getsize(os.path.join(tree, f)) for f in os.listdir(tree)) / 2**20
        if lzw_native.get_lib() is None:
            raise AssertionError(f"G1: the native LZW codec did not build: "
                                 f"{lzw_native.build_error}")
        tiffio.reset_codec_calls()
        t0 = time.perf_counter()  # read_tiff alone; the comparison after it
        back = [(tiffio.read_tiff(os.path.join(tree, f"S2_{i:04d}_10m.tif")),
                 tiffio.read_tiff(os.path.join(tree, f"S2_{i:04d}_05m.tif")))
                for i in range(G_TILES)]
        read_s = time.perf_counter() - t0
        for i, ((lr, hr), (got_lr, got_hr)) in enumerate(zip(pairs, back)):
            if not (np.array_equal(got_lr, lr) and np.array_equal(got_hr, hr)):
                raise AssertionError(f"G1: tile pair {i} read back differs from what was written")
        del back
        calls = dict(tiffio.CODEC_CALLS)
        if calls["python_decode"] or calls["native_decode"] != 2 * G_TILES:
            raise AssertionError(f"G1: the native decoder did not decode every strip: {calls}")
        with tiffio.TiffReader(os.path.join(tree, "S2_0000_05m.tif")) as r:
            r._fh.seek(r._offsets[0])
            strip = r._fh.read(r._counts[0])
        if lzw_native.lzw_decode_native(strip) != tiffio._lzw_decode(strip):
            raise AssertionError("G1: native and Python LZW decoders differ on a strip")
        log(f"G1 tree: {G_TILES} tile pairs (HR {G_HR}x{G_HR}x4, LR {G_HR // 2}x{G_HR // 2}x4, "
            f"int16, LZW + predictor), {raw_mb:.1f} MiB raw, {disk_mb:.1f} MiB on disk; "
            f"written in {write_s:.2f} s; read back equal in {read_s:.2f} s = "
            f"{raw_mb / read_s:.1f} MiB/s on one thread ({calls['native_decode']} strips by the "
            f"native decoder, {calls['python_decode']} by Python; native = Python on a "
            f"{len(strip)}-byte strip); card {card}")
        split = decode_split(tree, G_BATCH, tiffio, lzw_native)
        log(f"G1 one batch's {split['files']} files ({split['mib']:.1f} MiB) stage by stage on "
            f"one thread: open + read bytes {split['open_read_ms']:.1f} ms, native LZW "
            f"{split['lzw_ms']:.1f} ms ({split['mib'] / split['lzw_ms'] * 1e3:.1f} MiB/s), "
            f"predictor undo {split['undo_ms']:.1f} ms "
            f"({split['mib'] / split['undo_ms'] * 1e3:.1f} MiB/s); read_tiff whole "
            f"{split['read_tiff_ms']:.1f} ms, {split['rest_ms']:.1f} ms of it outside the three "
            f"stages; card {card}")
        out.update({"tiles": G_TILES, "raw_mib": raw_mb, "disk_mib": disk_mb,
                    "write_s": write_s, "read_s": read_s, "decode_mib_s": raw_mb / read_s,
                    "decode_split": split})
        del pairs

        # G2. the f32 CLI: per-step launches from phase F's probe (the same
        # model and batch shapes), run_task's from a probe of its own
        per_step = report["fit"]["per_step_launches"]
        cfg = CondSRVAEConfig(cr=G_CR, patch_size=G_PS)
        probe = CondSRVAE(cfg, device="cuda").init_weights(1)
        reset_path_counts(fc, fe)
        with open(os.devnull, "w") as null:
            import contextlib

            with contextlib.redirect_stdout(null):
                run_task(probe, [training_batch(13)], "probe", G_CR, samples=1000,
                         results_root=os.path.join(tmp, "probe"))
        torch.cuda.synchronize()
        task_counts = path_counts(fc, fe)
        del probe
        torch.cuda.empty_cache()
        reset_path_counts(fc, fe)
        tiffio.reset_codec_calls()
        args = cli_flags(tree, "--epochs", "2", "--pre_epochs", "1", "--val_metrics_every", "1",
                         "--samples", "1000", "--tensorboard", "--workers", "4")
        res, g2_ms = timed(lambda: run_cli("g2", args))
        got = path_counts(fc, fe)
        lpips_on = res["trainer"]._lpips_params is not None
        n = {"pretrain": 4, "train": 8, "val": 2, "metrics": 2, "images": 2 if lpips_on else 1}
        want = {k: sum(n[kind] * per_step[kind].get(k, 0) for kind in n) + task_counts.get(k, 0)
                for k in got}
        if got != want:
            raise AssertionError(f"G2 CLI launches {got}, expected {want} (steps {n} + run_task)")
        records, run_dir = run_records("g2")
        keys = {k for r in records for k in r} - {"_step", "_time"}
        want_keys = set(engine.FIT_KEYS["cond"]) | {engine.PRETRAIN_KEY}
        if lpips_on:
            want_keys |= set(engine.LPIPS_KEYS["cond"])
        if keys != want_keys:
            raise AssertionError(f"G2 logged keys {sorted(keys ^ want_keys)} differ from the JAX "
                                 "fit's")
        if not os.path.exists(os.path.join("ckpt", "g2.pt")):
            raise AssertionError("G2: no checkpoint at ckpt/g2")
        mmse = res["task"]["mmse"]
        if not math.isfinite(mmse):
            raise AssertionError(f"G2: MMSE {mmse}")
        (tb_name,) = os.listdir(os.path.join(run_dir, "tb"))
        tb = read_tfevents(os.path.join(run_dir, "tb", tb_name))
        tb_keys = {k for r in tb for k in r} - {"step", "file_version"}
        if not set(engine.FIT_KEYS["cond"]) <= tb_keys:
            raise AssertionError(f"G2 tfevents lack {set(engine.FIT_KEYS['cond']) - tb_keys}")
        epoch_s = [r["Perf/train_epoch_seconds"] for r in records
                   if "Perf/train_epoch_seconds" in r]
        pngs = sorted(f for f in os.listdir(res["task"]["results_dir"]) if f.endswith(".png"))
        log(f"G2 CLI f32 (pre 1 + 2 epochs, 4 steps of {G_BATCH} tiles from disk, --workers 4, "
            f"run_task N=1000): launches " + " ".join(f"{k}={v}" for k, v in got.items() if v)
            + f" = per-step counts x (pretrain 4, train 8, val 2, metrics 2, images "
            f"{n['images']}) + run_task's; train epochs "
            + ", ".join(f"{1e3 * t:.1f}" for t in epoch_s) + f" ms; whole run {g2_ms:.1f} ms; "
            f"MMSE {mmse:.6f}; logged keys = the JAX fit's ({len(keys)}); checkpoint "
            f"ckpt/g2.pt; tfevents {len(tb)} records read back; task PNGs "
            + (", ".join(pngs) if pngs else "not written (no matplotlib)")
            + f"; LZW strips native {tiffio.CODEC_CALLS['native_decode']}, Python "
            f"{tiffio.CODEC_CALLS['python_decode']}; card {card}")
        if tiffio.CODEC_CALLS["python_decode"]:
            raise AssertionError("G2: a strip took the Python LZW decoder")
        out.update({"g2_launches": got, "g2_task_launches": task_counts,
                    "g2_train_epoch_seconds": epoch_s, "g2_ms": g2_ms, "g2_mmse": mmse,
                    "task_pngs": pngs})
        trained = res["trainer"].model
        del res
        torch.cuda.empty_cache()

        # G3. the loader's pace: a train epoch from disk against one from the
        # same batches held on the card, f32 and bf16, 1 and 4 decode threads
        pace, pace_trace = [], {}
        for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            bf = dtype == torch.bfloat16
            tr = Trainer(CondSRVAE(cfg, device="cuda", dtype=dtype).init_weights(0),
                         TrainConfig(use_bfloat16=bf), device="cuda")
            held = list(init_dataloader("s2v", G_BATCH, G_PS, crop="grid", data_root=tree,
                                        seed=0, workers=4)[0])
            loader_epoch(tr, held)  # warm-up
            mem_ms, steps, _ = loader_epoch(tr, held)
            for workers in (1, 4):
                loader = init_dataloader("s2v", G_BATCH, G_PS, crop="grid", data_root=tree,
                                         seed=0, workers=workers, timing=True)[0]
                disk_ms, steps_d, t = loader_epoch(tr, loader, loader)
                loader.close()
                rest_ms = 1e3 * (t["wait_s"] - t["wait_first_s"])
                # the epoch less the first batch's wait (no prefetch hides it)
                # against the epoch from memory: what is left over either
                # waits on the queue, or is the steps' host path slowed while
                # the decode threads run beside it (the GIL, the host's cores)
                slower_ms = disk_ms - 1e3 * t["wait_first_s"] - mem_ms - rest_ms
                if rest_ms > 0.05 * mem_ms:
                    bound = "loader (the step waits on the queue)"
                elif slower_ms > 0.05 * mem_ms:
                    bound = "loader (the steps run slower while it decodes; see the trace)"
                else:
                    bound = "step"
                row = {"dtype": label, "workers": workers, "disk_epoch_ms": disk_ms,
                       "memory_epoch_ms": mem_ms, "steps": steps_d,
                       "wait_ms": 1e3 * t["wait_s"], "wait_first_ms": 1e3 * t["wait_first_s"],
                       "wait_after_first_ms": rest_ms, "steps_slower_ms": slower_ms,
                       "h2d_ms": t["h2d_ms"], "crop_ms": t["crop_ms"], "paced_by": bound}
                pace.append(row)
                log(f"G3 {label} --workers {workers}: epoch from disk {disk_ms:.1f} ms vs "
                    f"{mem_ms:.1f} ms from batches on the card ({steps_d} steps); the "
                    f"step waited {row['wait_ms']:.1f} ms on the loader's queue "
                    f"({row['wait_first_ms']:.1f} for the first batch, {rest_ms:.1f} after); "
                    f"the steps took {slower_ms:.1f} ms more than from memory besides; "
                    f"copies {t['h2d_ms']:.2f} ms, crops {t['crop_ms']:.2f} ms on the card; "
                    f"the {bound} sets the pace; card {card}")
            # where the w4 epoch's extra time goes: the same two epochs traced
            trace_dir = os.path.join(ROOT, "chiprun_out")
            os.makedirs(trace_dir, exist_ok=True)
            traced = {"memory": traced_epoch(
                tr, held, os.path.join(trace_dir, f"g3_trace_{label}_memory.json.gz"))}
            loader = init_dataloader("s2v", G_BATCH, G_PS, crop="grid", data_root=tree,
                                     seed=0, workers=4)[0]
            traced["disk w4"] = traced_epoch(
                tr, loader, os.path.join(trace_dir, f"g3_trace_{label}_disk_w4.json.gz"))
            loader.close()
            pace_trace[label] = traced
            log(f"G3 trace {label} (torch.profiler, chiprun_out/g3_trace_{label}_*.json.gz): "
                + " | ".join(f"{src}: epoch {t['epoch_ms']:.1f} ms, card busy {t['busy_ms']:.1f} "
                             f"ms (idle {100 * t['idle_share']:.1f}%), host in the "
                             f"{t['steps']} steps {t['in_steps_ms']:.1f} ms, before the first "
                             f"{t['before_first_ms']:.1f}, between {t['between_ms']:.1f}, "
                             f"after the last {t['after_last_ms']:.1f}; operators "
                             + ", ".join(f"{k} {v:.1f} ms" for k, v in t["op_ms_by_thread"].items())
                             + "; "
                             "CUDA runtime " + ", ".join(f"{k} {v[0]:.1f} ms x{v[1]}"
                                                         for k, v in t["runtime_top"].items())
                             for src, t in traced.items()) + f"; card {card}")
            del tr, held
            torch.cuda.empty_cache()
        out["pace"] = pace
        out["pace_trace"] = pace_trace

        # G4. resume, --test with the flags from the checkpoint, --test --int8
        meta = json.load(open(os.path.join("ckpt", "g2.meta.json")))
        reset_path_counts(fc, fe)
        res = run_cli("g2", cli_flags(tree, "--epochs", "3", "--samples", "1000",
                                      "--workers", "4", "--model_ckpt", "ckpt/g2"))
        sched = res["trainer"].scheduler.state_dict()
        if res["start_epoch"] != meta["epoch"] + 1 or \
                sched["last_epoch"] != meta["scheduler"]["last_epoch"] + 3 - meta["epoch"]:
            raise AssertionError(f"G4 resume: start {res['start_epoch']}, scheduler {sched}, "
                                 f"meta {meta}")
        resumed = path_counts(fc, fe)
        del res
        # no model flags: they come from the checkpoint's meta
        targv = ["--test", "--model_ckpt", "ckpt/g2", "--dataset", "s2v", "--data_root", tree,
                 "--crop", "grid", "--batch_size", str(G_BATCH), "--samples", "1000"]
        targs = cli_args(targv)
        if (targs.model_type, targs.compression_ratio, targs.patch_size) != ("Cond_SRVAE", G_CR,
                                                                             G_PS):
            raise AssertionError(f"G4 --test flags from the meta: {vars(targs)}")
        reset_path_counts(fc, fe)
        res = run_cli("g4", targs)
        test_counts = path_counts(fc, fe)
        if test_counts != task_counts:
            raise AssertionError(f"G4 --test launches {test_counts}, expected run_task's "
                                 f"{task_counts}")
        del res
        reset_all_counts()
        reset_path_counts(fc, fe)
        res = run_cli("g4i", cli_args(targv + ["--int8"]))
        int8_counts = {**all_counts(), **path_counts(fc, fe)}
        for k in ("quantize_stochastic", "int8_conv3x3_bn_relu", "int8_convT4x4s2_bn_relu",
                  "act_absmax", "act_quant"):
            if not int8_counts.get(k):
                raise AssertionError(f"G4 --test --int8 launched {k} no time: {int8_counts}")
        if not math.isfinite(res["task"]["mmse"]):
            raise AssertionError(f"G4 --int8 MMSE {res['task']['mmse']}")
        log(f"G4 resume from ckpt/g2 (epoch {meta['epoch']}): started at epoch "
            f"{meta['epoch'] + 1}, scheduler carried over ({sched}); launches "
            + " ".join(f"{k}={v}" for k, v in resumed.items() if v)
            + f" | --test --model_ckpt: flags from the meta (Cond_SRVAE, cr {G_CR}, ps {G_PS}), "
            f"launches = run_task's | --test --int8: MMSE {res['task']['mmse']:.6f}, launches "
            + " ".join(f"{k}={v}" for k, v in int8_counts.items() if v) + f"; card {card}")
        out.update({"g4_resume_launches": resumed, "g4_test_launches": test_counts,
                    "g4_int8_launches": int8_counts, "g4_int8_mmse": res["task"]["mmse"]})
        del res
        torch.cuda.empty_cache()

        # G5. bf16 with bf16 first moments, one epoch
        reset_path_counts(fc, fe)
        res = run_cli("g5", cli_flags(tree, "--epochs", "1", "--samples", "1000", "--bf16",
                                      "--bf16_moments", "--workers", "4"))
        wg = {f"{name} {role}": v["wg"] for name, roles in fc.bf16_impl_launches.items()
              for role, v in roles.items() if v["wg"]}
        tc = {f"{name} {role}": v["tc"] for name, roles in fc.bf16_impl_launches.items()
              for role, v in roles.items() if v["tc"]}
        records, _ = run_records("g5")
        bf_epoch = [r["Perf/train_epoch_seconds"] for r in records
                    if "Perf/train_epoch_seconds" in r]
        if not wg or not all(m.dtype == torch.bfloat16 for m in res["trainer"].opt.mu) \
                or not math.isfinite(res["task"]["mmse"]):
            raise AssertionError(f"G5 bf16: wg launches {wg}, MMSE {res['task']['mmse']}")
        log(f"G5 CLI --bf16 --bf16_moments 1 epoch: train epoch {1e3 * bf_epoch[0]:.1f} ms; "
            f"conv_wg_bf16 launches " + " ".join(f"{k}={v}" for k, v in wg.items())
            + "; conv_tc_bf16 " + " ".join(f"{k}={v}" for k, v in tc.items())
            + f"; mu in bfloat16; MMSE {res['task']['mmse']:.6f}; card {card}")
        out.update({"g5_wg_launches": wg, "g5_tc_launches": tc, "g5_epoch_seconds": bf_epoch})
        del res
        torch.cuda.empty_cache()

        # G6. evaluate: one val tile super-resolved patch by patch by the
        # trained model, reassembled, against its HR tile, with its LR tile
        lr_path = os.path.join(tree, f"S2_{G_TILES - 1:04d}_10m.tif")
        hr_path = os.path.join(tree, f"S2_{G_TILES - 1:04d}_05m.tif")
        lr_tile = torch.from_numpy(tiffio.read_tiff(lr_path).astype(np.float32))[None]
        patches = grid_patchify(lr_tile, G_PS // 2).cuda()
        sr = SuperResolver(trained, device="cuda", seed=0).super_resolve(patches, seed=1)
        # back to digital numbers through each LR patch's per-channel range
        # (the model's output is in the normalized domain of its input patch)
        lo = patches.amin(dim=(1, 2), keepdim=True)
        span = patches.amax(dim=(1, 2), keepdim=True) - lo + 1e-5
        product = grid_unpatchify(sr * span + lo, G_HR // G_PS)[0].cpu().numpy()
        prod_path = os.path.join(tmp, "sr.tif")
        tiffio.write_tiff(prod_path, product)
        results = {}
        cover = ["--stream", "--win", str(G_HR)]  # one window over the whole tile
        for label, extra in (("in memory", []), ("stream covering", cover),
                             ("stream", ["--stream"])):
            rc, text = main_output(lambda: ev.main([prod_path, hr_path, "--lr", lr_path]
                                                   + extra))
            if rc != 0:
                raise AssertionError(f"G6 evaluate {label} exited {rc}")
            results[label] = json.loads(text.strip().splitlines()[-1])
        a, b = results["in memory"], results["stream covering"]
        for key in ("psnr", "ssim", "rmse_input_units", "psnr_baseline", "ssim_baseline"):
            if not abs(a[key] - b[key]) <= 1e-4 * max(abs(a[key]), 1e-6):
                raise AssertionError(f"G6 {key}: in memory {a[key]} vs streamed {b[key]}")
        log(f"G6 evaluate (a val tile, {len(patches)} patches super-resolved, reassembled and "
            f"put back in digital numbers, against its HR tile, --lr): "
            + " | ".join(f"{k}: " + " ".join(f"{m}={v}" for m, v in r.items() if m != "metric")
                         for k, r in results.items())
            + f"; in memory = streamed with one window within 1e-4; card {card}")
        out["g6"] = results

        # G7. doctor
        rc, text = main_output(lambda: doctor.main([]))
        if rc != 0 or card not in text:
            raise AssertionError(f"G7 doctor exited {rc}, the card's line {card!r} "
                                 f"{'printed' if card in text else 'missing'}")
        log(f"G7 doctor: exit {rc}, printed {card}")
        out["g7_doctor_rc"] = rc
    finally:
        os.chdir(cwd)
        if job_env is None:
            os.environ.pop("SLURM_JOB_ID", None)
        else:
            os.environ["SLURM_JOB_ID"] = job_env
    report["cli"] = out
    return out


def bound_row(row, ops, nbytes, peak_ops):
    row["ops"], row["bytes"] = ops, nbytes
    row["bound_ms"] = 1e3 * max(ops / peak_ops, nbytes / PEAK_BYTES)
    row["bound_by"] = "operations" if ops / peak_ops > nbytes / PEAK_BYTES else "bytes"


def int8_gemm_ms(f8, name, qx, kq, reps):
    """cuBLASLt's int8 GEMM (``torch._int_mm``, int32 out) at the (M, N, K)
    of int8 conv ``name`` on the quantized input ``qx``: A its im2col (the
    strided conv's 16 taps at stride 2, the transposed conv's four phases
    stacked along M), B the channel-padded weight with N padded to 8, both
    built outside the timing.
    Not the same function (no quantize pass, no epilogue): a yardstick of
    the int8 tensor-core rate. None where ``torch._int_mm`` does not exist or
    M is too small for it."""
    if not hasattr(torch, "_int_mm"):
        return None
    b, h, w, cp = qx.shape
    c, o = kq.shape[2], kq.shape[3]
    xp = F.pad(qx, (0, 0, 1, 1, 1, 1))
    st = 2 if name == "int8_conv4x4s2_bn_relu" else 1
    ho, wo = h // st, w // st
    if name == "int8_conv3x3_bn_relu":
        groups = [[(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]]
    elif st == 2:
        groups = [[(dy, dx) for dy in (-1, 0, 1, 2) for dx in (-1, 0, 1, 2)]]
    else:  # per phase (u, v) its four live taps
        groups = [[(ta + u - 1, tb + v - 1) for ta in (0, 1) for tb in (0, 1)]
                  for u in (0, 1) for v in (0, 1)]
    a = torch.cat([torch.cat([xp[:, 1 + dy:1 + dy + st * ho:st, 1 + dx:1 + dx + st * wo:st]
                              for dy, dx in taps], dim=-1).reshape(b * ho * wo, -1)
                   for taps in groups])
    o8 = -(-o // 8) * 8
    # (taps * Cp, N8): all nine or sixteen taps; for the transposed conv four
    # taps' rows, one phase's K (the values do not change the time)
    bw = F.pad(kq, (0, o8 - o, 0, cp - c)).reshape(-1, o8)[:a.shape[1]].contiguous()
    if a.shape[0] <= 16:
        return None
    return cuda_ms(lambda: torch._int_mm(a, bw), reps)


def check_int8_shape(f8, fc, name, shape, o, relu, seed, timing: bool, act_group=None,
                     dtype=torch.float32):
    """Int8 kernel (absmax pass, quantize pass and the W8A8 conv on the int8
    tensor cores) vs its exact plain version at one shape, bit for bit, and
    the quantize pass vs its plain version; with ``timing``, also the times
    (events, and the call's device time by the profiler), the float32
    kernel's time at the same shape, the absmax and quantize passes alone
    and cuBLASLt's int8 GEMM at the same GEMM shape. With ``dtype`` bfloat16
    x and the output are bfloat16 (the ``*_bf16`` instances), and beside the
    kernel stand the bfloat16 #1/#5/#6 kernel and one cuDNN bfloat16 call on
    the dequantized weights (same geometry, not the same function: no
    activation quantization) instead of the float32 kernel."""
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if name == "int8_conv3x3_bn_relu" else 4
    c = shape[-1]
    # images of different ranges, so that the grouping of the scale matters
    x = torch.randn(shape, generator=gen, device="cuda")
    x = (x * (0.25 + 2 * torch.rand((shape[0], 1, 1, 1), generator=gen, device="cuda"))).to(dtype)
    item = x.element_size()
    kernel = torch.randn((k, k, c, o), generator=gen, device="cuda") / math.sqrt(k * k * c)
    kq, ks = qz.quantize_rtn(kernel)
    scale = torch.rand((o,), generator=gen, device="cuda") + 0.5
    shift = torch.randn((o,), generator=gen, device="cuda")
    packed = f8.pack_kernel_q(kq)

    def run():
        return f8.WRAPPERS[name](x, kq, ks, scale, shift, relu=relu, act_group=act_group,
                                 packed=packed)

    got = run()
    want = f8.PLAIN[name](x, kq, ks, scale, shift, relu, act_group)
    amax = f8.act_absmax(x, act_group)
    amax_want = f8.act_absmax_plain(x, act_group)
    torch.cuda.synchronize()
    err, ref = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    if not (err <= INT8_TOL * ref) or not torch.isfinite(got).all() or got.dtype != dtype:
        raise AssertionError(f"{name} {shape}->{o} group {act_group} {dtype}: max|diff| {err} > "
                             f"{INT8_TOL} * {ref}")
    if not torch.equal(amax, amax_want):
        raise AssertionError(f"act_absmax {shape} group {act_group}: {amax} != {amax_want}")
    if not torch.equal(run(), got):
        raise AssertionError(f"{name} {shape}->{o}: two runs differ")
    row = {"name": name, "x": list(shape), "o": o, "relu": relu, "act_group": act_group,
           "max_abs_err": err, "max_abs_ref": ref,
           "equal_share": float((got == want).float().mean())}
    # exact int32 sums and the plain version's epilogue: the same bits
    if not torch.equal(got, want):
        raise AssertionError(f"{name} {shape}->{o} group {act_group}: "
                             f"{100 * row['equal_share']:.4f}% equal to the last bit")
    qx = f8.act_quant(x, amax, act_group)
    if not torch.equal(qx, f8.act_quant_plain(x, amax_want, act_group)):
        raise AssertionError(f"act_quant {shape} group {act_group}: bytes differ from the "
                             f"plain version")
    if timing:
        first = cuda_ms(run, 1)
        reps = max(3, min(50, int(30.0 / max(first, 1e-3))))
        row["ms"] = cuda_ms(run, reps)
        # the call's device work: the absmax memset and kernel, the quantize
        # pass, the conv and its K-split reduce
        row["device_ms"] = profiled_device_ms(run, 10, ("act_absmax", "emset", "act_quant",
                                                        "int8_tc", "splitk_reduce"))
        row["gemm_ms"] = int8_gemm_ms(f8, name, qx, kq, reps)
        row["plain_ms"] = cuda_ms(
            lambda: f8.PLAIN[name](x, kq, ks, scale, shift, relu, act_group), 2)
        row["library_ms"] = None
        deq = qz.dequantize(kq, ks).to(dtype)
        fname = f8.float_name(name)
        float_ms = cuda_ms(lambda: fc.WRAPPERS[fname](x, deq, scale, shift, relu=relu), reps)
        if dtype == torch.bfloat16:
            row["bf16_kernel_ms"] = float_ms
            row["cudnn_bf16_ms"] = cuda_ms(library_fn(fname, x, deq, scale, shift, relu), reps)
        else:
            row["f32_kernel_ms"] = float_ms
        m, n, _, phases = f8.geometry(name, shape, o)
        taps = fc._KERNELS[fname][1]
        bound_row(row, 2.0 * phases * m * n * taps * c,
                  item * x.numel() + kq.numel() + 4.0 * 3 * o + item * got.numel(), PEAK_INT8_OPS)
        groups = amax.numel()
        # 50 calls a timing (at most 0.4 ms each): the first call's host time
        # stays out of the big shapes' numbers, as it does for the library's
        absmax = {"name": "act_absmax", "x": list(shape), "groups": groups,
                  "ms": cuda_ms(lambda: f8.act_absmax(x, act_group), 50),
                  "plain_ms": cuda_ms(lambda: f8.act_absmax_plain(x, act_group), 50),
                  "library_ms": cuda_ms(lambda: torch.linalg.vector_norm(
                      x.view(groups, -1), float("inf"), dim=1), 50)}
        bound_row(absmax, float(x.numel()), item * x.numel() + 4.0 * groups, PEAK_F32_FLOPS)
        # the pass's device work: its result's memset and its kernel
        absmax["device_ms"] = profiled_device_ms(lambda: f8.act_absmax(x, act_group), 20,
                                                 ("act_absmax", "emset"))
        if absmax["device_ms"]:
            absmax["share_of_bound_device"] = absmax["bound_ms"] / absmax["device_ms"]
        row["absmax"] = absmax
        # 4 bytes read and round_up(C, 16) / C written per element, the
        # group scales read; a true division per element
        row["quant"] = {"name": "act_quant", "x": list(shape), "qx_bytes": qx.numel(),
                        "ms": cuda_ms(lambda: f8.act_quant(x, amax, act_group), 50),
                        "plain_ms": cuda_ms(lambda: f8.act_quant_plain(x, amax, act_group), 50),
                        "library_ms": None}
        bound_row(row["quant"], float(x.numel()),
                  item * x.numel() + qx.numel() + 4.0 * groups, PEAK_F32_FLOPS)
    return row


def quant_leaves(model, seed, prefixes):
    """``(name, w, seed)`` of every leaf ``quantize_params_tree(model, seed,
    prefixes)`` quantizes, in its order."""
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    out = []
    for path, mod in qz._conv_modules(model):
        leaf = path + ("kernel",)
        if any(comp.startswith(p) for comp in leaf for p in prefixes):
            out.append(("/".join(leaf), mod.kernel.detach(), qz.leaf_seed(seed, leaf)))
    return out


def check_quant_tree(label, leaves, stats: bool):
    """The stochastic-round quantizer on one quant tree (``quant_leaves``) in
    one C call: every leaf's q and scales equal to its plain version's, the
    same bytes on a second call, the call's launches; with ``stats`` also
    ``|q - w/scale| < 1``, the mean error within 4 standard errors of 0 and
    other bytes for another leaf's seed, per leaf. Times the call (events
    and profiler device time) against its bound."""
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    pairs = [(w, seed) for _, w, seed in leaves]
    before = qz.launches["quantize_stochastic"]
    got = qz.quantize_leaves(pairs)
    torch.cuda.synchronize()
    calls = qz.launches["quantize_stochastic"] - before
    if calls != 2:
        raise AssertionError(f"quantizer {label}: {calls} launches for one tree, expected 2")
    again = qz.quantize_leaves(pairs)
    prev = None
    leaf_rows = []
    for (name, w, seed), (q, scale), (q2, s2) in zip(leaves, got, again):
        q_plain, scale_plain = qz.quantize_stochastic_plain(w, seed)
        if not (torch.equal(q, q_plain) and torch.equal(scale, scale_plain)):
            raise AssertionError(f"quantizer {label} {name}: kernel and plain version differ in "
                                 f"{int((q != q_plain).sum())} bytes and "
                                 f"{int((scale != scale_plain).sum())} scales")
        if not (torch.equal(q2, q) and torch.equal(s2, scale)):
            raise AssertionError(f"quantizer {label} {name}: two calls differ")
        leaf_row = {"leaf": name, "shape": list(w.shape),
                    "max_abs_err": float((q.float() - q_plain.float()).abs().max())}
        if stats:
            x = (w / scale).double()
            err = q.double() - x
            frac = x - torch.floor(x)
            se = float(torch.sqrt((frac * (1 - frac)).sum())) / x.numel()
            if not float(err.abs().max()) < 1.0:
                raise AssertionError(f"quantizer {name}: |q - w/scale| reaches "
                                     f"{float(err.abs().max())}")
            if not abs(float(err.mean())) <= 4 * se:
                raise AssertionError(f"quantizer {name}: mean error {float(err.mean())} beyond "
                                     f"4 standard errors ({se})")
            if prev is not None and torch.equal(qz.quantize_stochastic(w, prev)[0], q):
                raise AssertionError(f"quantizer {name}: another leaf's seed gave the same bytes")
            prev = seed
            leaf_row.update(max_abs_round_err=float(err.abs().max()), mean_err=float(err.mean()),
                            mean_err_se=se)
            log(f"quantizer {name} {tuple(w.shape)}: bytes equal to the plain version, "
                f"max|q - w/s| {leaf_row['max_abs_round_err']:.4f}, mean error "
                f"{leaf_row['mean_err']:+.2e} (se {se:.2e})")
        leaf_rows.append(leaf_row)
    numel = sum(w.numel() for _, w, _ in leaves)
    width = sum(w.shape[-1] for _, w, _ in leaves)
    match = ("col_absmax", "stochastic_round", "emset")
    row = {"name": "quantize_stochastic", "tree": label, "leaves": leaf_rows,
           "elements": numel, "launches": calls,
           "max_abs_err": max(r["max_abs_err"] for r in leaf_rows),
           "ms": cuda_ms(lambda: qz.quantize_leaves(pairs), 20),
           # a second window where the profiler records no device time in the first
           "device_ms": (profiled_device_ms(lambda: qz.quantize_leaves(pairs), 10, match)
                         or profiled_device_ms(lambda: qz.quantize_leaves(pairs), 10, match)),
           "plain_ms": cuda_ms(lambda: [qz.quantize_stochastic_plain(w, sd) for w, sd in pairs],
                               5),
           "library_ms": None}
    # each weight read once and each byte and scale written once; per element a
    # division, floor, subtract, compare, add and two clamps
    bound_row(row, 7.0 * numel, 5.0 * numel + 4.0 * width, PEAK_F32_FLOPS)
    log(f"quantizer tree {label}: {len(leaves)} leaves, {numel} elements in one call of "
        f"{calls} launches, every leaf's bytes and scales equal to the plain version; "
        f"{row['ms']:.4f} ms by events, device {row['device_ms']} ms, plain {row['plain_ms']:.3f} "
        f"ms, bound {row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def check_quantizer(model, report):
    """Phase I2: the stochastic-round quantizer on the canonical W8A8 tree."""
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    leaves = quant_leaves(model, 0, qz.DECODER_PREFIXES)
    if len(leaves) != 18:
        raise AssertionError(f"expected 18 decoder kernels, found {len(leaves)}")
    rows = report["quantizer"] = [check_quant_tree("decoder", leaves, stats=True)]
    return rows  # phase I4 adds the block path's trees


def record_routed_calls(model, calls):
    """Hooks recording ``(kernel, x shape, O, relu)`` of every conv the
    model's next eval passes launch, float32 or int8 as the module routes it."""
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks

    def conv_pre(m, args):
        name = "int8_conv3x3_bn_relu" if m.kernel_q is not None else "fused_conv3x3_bn_relu"
        calls.append((name, tuple(args[0].shape), m.kernel.shape[-1], False))

    def block_pre(m, args):
        tail = getattr(m, m._tail_name)
        int8 = tail.kernel_q is not None and args[0].shape[-1] >= m._int8_min_channels
        calls.append((m._int8_kernel if int8 else m._kernel, tuple(args[0].shape),
                      tail.kernel_q.shape[-1] if int8 else tail.kernel.shape[-1], True))

    hooks = []
    for mod in model.modules():
        if isinstance(mod, blocks.Conv3x3):
            hooks.append(mod.register_forward_pre_hook(conv_pre))
        if isinstance(mod, (blocks.DownBlock, blocks.UpBlock)):
            hooks.append(mod.register_forward_pre_hook(block_pre))
    return hooks


def psnr_db(a, b) -> float:
    return float(10 * torch.log10(1.0 / torch.clamp_min(((a - b) ** 2).mean(), 1e-12)))


def all_counts():
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    return {**fc.launches, **f8.launches, **qz.launches}


def reset_all_counts():
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    fc.reset_launches()
    f8.reset_launches()
    qz.reset_launches()


def serve_requests(sr, y, calls=()):
    """The two requests of the serving run: outputs, first-call times, the
    launch counts after the first and how many of ``calls`` it recorded."""
    out, sr_ms = timed(lambda: sr.super_resolve(y, seed=11))
    after_sr, n_sr_calls = all_counts(), len(calls)
    uq, uq_ms = timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))
    served_ok("super_resolve", out, (16, 64, 64, 4))
    for key in ("mean", "std", "variance"):
        if tuple(uq[key].shape) != (64, 64, 4) or not torch.isfinite(uq[key]).all():
            raise AssertionError(f"uncertainty[{key}] is wrong")
    if not float(uq["std"].max()) > 0:
        raise AssertionError("uncertainty draws do not differ")
    return out, uq, sr_ms, uq_ms, after_sr, n_sr_calls


def int8_phase(report, model, y, f32_out, f32_uq, f32_launches):
    """Phases I1-I6; returns per-kernel totals over the int8 serving run and
    the block path, and each kernel's launches by path."""
    from simple_vae_rs_tpu_torch import SuperResolver
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    int8_report = report["int8"] = {"ragged": [], "shapes": []}
    # I1. ragged shapes
    for i, (name, shape, o, relu, group) in enumerate(RAGGED_INT8):
        row = check_int8_shape(f8, fc, name, shape, o, relu, seed=600 + i, timing=False,
                               act_group=group)
        int8_report["ragged"].append(row)
        log(f"ragged {name} x{shape} O={o} relu={relu} act_group={group}: max|diff| "
            f"{row['max_abs_err']:.3e} ({100 * row['equal_share']:.2f}% equal to the last bit)")
    # I2. the quantizer
    quant_rows = check_quantizer(model, report)

    # I3. the W8A8 resolver: build, super_resolve B=16, uncertainty N=1000
    calls = []
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    sr8 = SuperResolver(model, device="cuda", seed=0, int8=True)
    if qz.has_quant(model) or not qz.has_quant(sr8.model):
        raise AssertionError("int8=True must quantize its own copy of the model")
    hooks = record_routed_calls(sr8.model, calls)
    out8, uq8, sr_ms, uq_ms, after_sr, n_sr_calls = serve_requests(sr8, y, calls)
    counts = all_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for h in hooks:
        h.remove()
    if counts["quantize_stochastic"] != 2:  # one tree, one call of two launches
        raise AssertionError(f"the quantizer launched {counts['quantize_stochastic']} times")
    for name, want in INT8_EXPECTED.items():
        per_uq = counts[name] - after_sr[name]
        recorded = sum(1 for c in calls if c[0] == name)
        if name not in (f8.ABSMAX, f8.QUANT) and recorded != counts[name]:
            raise AssertionError(f"int8 serving {name}: {counts[name]} launches, {recorded} calls")
        if after_sr[name] != want or per_uq != want:
            raise AssertionError(f"int8 serving {name}: {after_sr[name]} launches per "
                                 f"super_resolve and {per_uq} per uncertainty, expected {want}")
    log("int8 serving launches (build + super_resolve + uncertainty): "
        + " ".join(f"{k}={v}" for k, v in counts.items()))
    rep_sr = [timed(lambda: sr8.super_resolve(y, seed=11))[1] for _ in range(5)]
    rep_uq = [timed(lambda: sr8.uncertainty(y[0], samples=1000, seed=12))[1] for _ in range(3)]

    blocks.use_plain_path(sr8.model)
    before = all_counts()
    plain_sr = sr8.super_resolve(y, seed=11)
    plain_uq = sr8.uncertainty(y[0], samples=1000, seed=12)
    torch.cuda.synchronize()
    if all_counts() != before:
        raise AssertionError("the int8 plain path launched a kernel")
    blocks.use_plain_path(sr8.model, False)
    serve_err, beyond = {}, {}
    for key, a, b in (("super_resolve", out8, plain_sr),
                      ("uncertainty.mean", uq8["mean"], plain_uq["mean"]),
                      ("uncertainty.std", uq8["std"], plain_uq["std"])):
        diff = (a - b).abs()
        serve_err[key], beyond[key] = float(diff.max()), float((diff > 1e-5).float().mean())
        if not serve_err[key] <= INT8_SERVE_TOL:
            raise AssertionError(f"int8 {key}: kernels vs plain path max|diff| "
                                 f"{serve_err[key]} > {INT8_SERVE_TOL}")
    psnr = {"super_resolve": psnr_db(out8, f32_out), "uncertainty.mean": psnr_db(uq8["mean"],
                                                                                 f32_uq["mean"])}
    for key, db in psnr.items():
        if not db > MIN_PSNR_DB:
            raise AssertionError(f"int8 {key}: {db:.1f} dB against float32")
    log(f"int8 super_resolve B=16: {sr_ms:.2f} ms first call, repeats median "
        f"{statistics.median(rep_sr):.2f} ms; uncertainty N=1000: {uq_ms:.2f} ms first call, "
        f"repeats median {statistics.median(rep_uq):.2f} ms; peak memory {peak_gib:.2f} GiB")
    log(f"int8 kernels vs plain path max|diff| {serve_err}, share beyond 1e-5 {beyond}; "
        f"PSNR against float32 {psnr}")
    int8_report["serving"] = {
        "super_resolve_b16_ms": sr_ms, "super_resolve_b16_ms_repeats": rep_sr,
        "uncertainty_n1000_ms": uq_ms, "uncertainty_n1000_ms_repeats": rep_uq,
        "peak_memory_gib": peak_gib, "max_abs_err_vs_plain": serve_err,
        "share_beyond_1e-5_vs_plain": beyond, "psnr_db_vs_f32": psnr, "launches": counts,
        "launches_super_resolve_b16": after_sr,
    }
    del sr8, plain_sr, plain_uq

    # I4. kernel #11 through the block path
    block_calls = []
    rng = np.random.default_rng(5)
    reset_all_counts()
    worst_block = 0.0
    block_trees = []
    for i, (cin, cout, hw) in enumerate(DOWN_BLOCKS):
        block = blocks.DownBlock(cin, cout, device="cuda").eval()
        for mod in block.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(rng)
        randomize_bn(block, seed=20 + i)
        tree = qz.quantize_params_tree(block, seed=i, prefixes=("",))
        qz.attach_quant(block, tree)
        block_trees.append((f"DownBlock {cin}->{cout} at {hw}", quant_leaves(block, i, ("",)),
                            [tree["conv"], tree["downsample"]]))
        hooks = record_routed_calls(block, block_calls)
        x = torch.randn((16, hw, hw, cin), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(700 + i))
        with torch.no_grad():
            got = block(x)
            for h in hooks:
                h.remove()
            blocks.use_plain_path(block)
            want = block(x)
        torch.cuda.synchronize()
        err, ref = float((got - want).abs().max()), float(want.abs().max())
        worst_block = max(worst_block, err / ref)
        if not err <= INT8_TOL * ref or tuple(got.shape) != (16, hw // 2, hw // 2, cout):
            raise AssertionError(f"int8 DownBlock {cin}->{cout} at {hw}: max|diff| {err} > "
                                 f"{INT8_TOL} * {ref}")
    block_counts = all_counts()
    want_counts = {"int8_conv3x3_bn_relu": 6, "int8_conv4x4s2_bn_relu": 6, "act_absmax": 12,
                   "act_quant": 12, "quantize_stochastic": 12}
    for name, count in block_counts.items():
        if count != want_counts.get(name, 0):
            raise AssertionError(f"block path {name}: {count} launches, expected "
                                 f"{want_counts.get(name, 0)}")
    log(f"int8 DownBlocks at the canonical shapes (B=16): int8 4x4/s2 launched "
        f"{block_counts['int8_conv4x4s2_bn_relu']} times, worst max|diff| vs the plain path "
        f"{worst_block:.2e} of max|plain|")
    int8_report["block_path"] = {"launches": block_counts, "worst_rel_err": worst_block}
    # each block's tree: the attached leaves and a call of its own, against
    # the plain version, and timed
    for label, leaves, nodes in block_trees:
        for (name, w, seed), node in zip(leaves, nodes):
            q_plain, s_plain = qz.quantize_stochastic_plain(w, seed)
            if not (torch.equal(node["kernel_q"], q_plain)
                    and torch.equal(node["kernel_s"], s_plain)):
                raise AssertionError(f"quantizer {label} {name}: the attached leaf differs "
                                     f"from the plain version")
        quant_rows.append(check_quant_tree(label, leaves, stats=False))

    # I5. every distinct int8 shape of I3 and I4: check and time
    paths = (("serving_int8", [c for c in calls if c[0] in f8.PLAIN]),
             ("block_path", [c for c in block_calls if c[0] in f8.PLAIN]))
    per_key = {}
    fields = ("ms", "plain_ms", "bound_ms", "ops", "bytes", "f32_kernel_ms", "device_ms",
              "gemm_ms")
    totals, by_path = {}, {}
    for path, path_calls in paths:
        for call in path_calls:
            if call not in per_key:
                name, shape, o, relu = call
                row = per_key[call] = check_int8_shape(f8, fc, name, shape, o, relu,
                                                       seed=800 + len(per_key), timing=True)
                int8_report["shapes"].append(row)
                am, qt = row["absmax"], row.get("quant")
                log(f"int8 shape {name} x{shape} O={o}: kernel {row['ms']:.4f} ms (absmax pass "
                    f"{am['ms']:.4f} ms of it, device {am['device_ms']} ms = "
                    f"{am.get('share_of_bound_device')} of its bound, {am['bytes'] / 1e6:.1f} MB; "
                    f"absmax plain {am['plain_ms']:.4f}, library {am['library_ms']:.4f}, "
                    f"bound {am['bound_ms']:.4f}"
                    + (f"; quantize pass {qt['ms']:.4f} ms, plain {qt['plain_ms']:.4f}, bound "
                       f"{qt['bound_ms']:.4f}" if qt else "")
                    + f"), device {row['device_ms']} ms, plain {row['plain_ms']:.3f} ms, "
                    f"float32 kernel "
                    f"{row['f32_kernel_ms']:.4f} ms, int8 GEMM {row['gemm_ms']} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}), max|diff| "
                    f"{row['max_abs_err']:.2e}, equal share {row['equal_share']}")
            row = per_key[call]
            parts = [(call[0], row), (f8.ABSMAX, row["absmax"])]
            if "quant" in row:
                parts.append((f8.QUANT, row["quant"]))
            for kname, src in parts:
                tot = totals.setdefault(kname, dict.fromkeys(
                    fields + ("library_ms", "max_abs_err"), 0.0))
                for k in fields + ("library_ms",):
                    if src.get(k) is not None:
                        tot[k] += src[k]
                tot["max_abs_err"] = max(tot["max_abs_err"], src.get("max_abs_err", 0.0))
                by_path.setdefault(kname, {}).setdefault(path, 0)
                by_path[kname][path] += 1
    for row in int8_report["ragged"]:
        totals[row["name"]]["max_abs_err"] = max(totals[row["name"]]["max_abs_err"],
                                                 row["max_abs_err"])
    for name in list(f8.PLAIN) + [f8.QUANT]:
        totals[name]["library_ms"] = None
    tot = totals["quantize_stochastic"] = dict.fromkeys(fields + ("max_abs_err",), 0.0)
    for row in quant_rows:  # the decoder's tree and the six blocks'
        for k in ("ms", "plain_ms", "bound_ms", "ops", "bytes", "device_ms"):
            tot[k] += row[k] or 0.0
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
    tot["library_ms"] = None
    by_path["quantize_stochastic"] = {"serving_int8": counts["quantize_stochastic"],
                                      "block_path": block_counts["quantize_stochastic"]}
    for name, tot in totals.items():
        log(f"int8 paths {name}: launches {by_path[name]}, kernel {tot['ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms"
            + (f", float32 kernel {tot['f32_kernel_ms']:.3f} ms" if tot["f32_kernel_ms"] else ""))
    am = totals["act_absmax"]
    big = [r["absmax"] for r in per_key.values() if r["absmax"]["bytes"] >= 64e6]
    am_share = am["bound_ms"] / am["device_ms"] if am["device_ms"] else None
    log(f"int8 paths act_absmax: events {am['ms']:.3f} ms against torch.linalg.vector_norm "
        f"{am['library_ms']:.3f} ms; profiler device time {am['device_ms'] or 'not measured'} "
        f"ms, {am_share} of the bytes bound; at the shapes of 64 MB or more: "
        + ", ".join(f"{r['x']} {r.get('share_of_bound_device')}" for r in big))
    int8_report["absmax"] = {"ms": am["ms"], "library_ms": am["library_ms"],
                             "device_ms": am["device_ms"], "bound_ms": am["bound_ms"],
                             "share_of_bound_device_64mb_and_up":
                                 {str(r["x"]): r.get("share_of_bound_device") for r in big}}
    kernel_ms = {c: r["ms"] for c, r in per_key.items()}
    for req, part, wall in (("super_resolve_b16", calls[:n_sr_calls], rep_sr),
                            ("uncertainty_n1000", calls[n_sr_calls:], rep_uq)):
        part = [c for c in part if c[0] in f8.PLAIN]
        busy = sum(kernel_ms[c] for c in part)
        f32_busy = sum(per_key[c]["f32_kernel_ms"] for c in part)
        wall_ms = statistics.median(wall)
        int8_report["serving"][f"{req}_int8_kernel_ms"] = busy
        int8_report["serving"][f"{req}_same_convs_f32_kernel_ms"] = f32_busy
        log(f"int8 {req}: the {len(part)} int8 convs take {busy:.3f} ms of {wall_ms:.3f} ms "
            f"median wall ({100 * busy / wall_ms:.1f}%); the float32 kernels take "
            f"{f32_busy:.3f} ms for the same convs")

    # I6. weights-only int8
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    srw = SuperResolver(model, device="cuda", seed=0, int8_weights=True)
    outw, uqw, w_sr_ms, w_uq_ms, _, _ = serve_requests(srw, y)
    w_counts = {k: v for k, v in all_counts().items() if v}
    w_peak = torch.cuda.max_memory_allocated() / 2**30
    if w_counts != f32_launches:
        raise AssertionError(f"weights-only serving launched {w_counts}, float32 serving "
                             f"{f32_launches}")
    params = dict(srw.model.named_parameters())
    held = [n for n in srw._packed if params[n].numel() != 0]
    if held or len(srw._packed) < 30:
        raise AssertionError(f"packed leaves held in float32 between requests: {held} "
                             f"({len(srw._packed)} packed)")
    packed_bytes = sum(q.numel() + 4 * s.numel() for q, s in srw._packed.values())
    dense_bytes = sum(4 * q.numel() for q, _ in srw._packed.values())
    w_psnr = {"super_resolve": psnr_db(outw, f32_out),
              "uncertainty.mean": psnr_db(uqw["mean"], f32_uq["mean"])}
    for key, db in w_psnr.items():
        if not db > MIN_PSNR_DB:
            raise AssertionError(f"int8_weights {key}: {db:.1f} dB against float32")
    w_rep_sr = [timed(lambda: srw.super_resolve(y, seed=11))[1] for _ in range(5)]
    w_rep_uq = [timed(lambda: srw.uncertainty(y[0], samples=1000, seed=12))[1] for _ in range(3)]
    log(f"int8_weights: {len(srw._packed)} leaves packed to {packed_bytes / 2**20:.1f} MiB "
        f"(float32 {dense_bytes / 2**20:.1f} MiB), none held in float32 between requests; "
        f"super_resolve B=16 median {statistics.median(w_rep_sr):.2f} ms, uncertainty N=1000 "
        f"median {statistics.median(w_rep_uq):.2f} ms, peak memory {w_peak:.2f} GiB; PSNR "
        f"against float32 {w_psnr}; launches {w_counts}")
    int8_report["weights_only"] = {
        "packed_leaves": len(srw._packed), "packed_bytes": packed_bytes,
        "dense_bytes": dense_bytes, "super_resolve_b16_ms": w_sr_ms,
        "super_resolve_b16_ms_repeats": w_rep_sr, "uncertainty_n1000_ms": w_uq_ms,
        "uncertainty_n1000_ms_repeats": w_rep_uq, "peak_memory_gib": w_peak,
        "psnr_db_vs_f32": w_psnr, "launches": w_counts,
    }
    f32_by_path = {name: {"serving_int8": counts[name]} for name in fc.launches}
    return totals, by_path, f32_by_path


# ------------------------------------------------------------------ the chain
CHAIN_SOURCE = "simple_vae_rs_tpu_torch/csrc/conv_chain.cu"
TAIL = (64, 16, 16, 4)  # later widths of a decoder tail, after its 64 input channels
# (x shape, later channel widths): one, two and four layers, odd H, W and
# channel widths, a 40-channel input (K over several weight slots), one image
# in many strips (seams inside it, the rings wrapping), an image too wide for
# full rows (panels), and a layer wider than one n tile (N = 136)
RAGGED_CHAIN = [
    ((2, 5, 7, 3), (6,)),
    ((3, 9, 11, 5), (7, 3)),
    ((2, 19, 23, 64), TAIL),
    ((1, 37, 21, 13), (18, 5, 9, 2)),
    ((1, 4, 4, 40), (24, 9)),
    ((1, 64, 64, 64), TAIL),
    ((4, 29, 30, 64), TAIL),
    ((1, 12, 200, 64), TAIL),
    ((1, 5, 6, 8), (136, 7)),
]
# every chain the canonical models launch: Cond_SRVAE (cr=1.2, ps=64:
# u_channels 53, z_channels 212) and VAE (cr=1.5, ps=32: latent_channels 42)
CHAIN_SHAPES = [
    ("Cond dx tail", (16, 64, 64, 64), TAIL), ("Cond dx tail", (1000, 64, 64, 64), TAIL),
    ("Cond dx tail", (512, 64, 64, 64), TAIL),
    ("Cond dy / VAE dec tail", (512, 32, 32, 64), TAIL),
    ("VAE dec tail", (1000, 32, 32, 64), TAIL),
    ("Cond ey tail", (1, 8, 8, 64), (64, 128, 128, 106)),
    ("Cond ey tail", (16, 8, 8, 64), (64, 128, 128, 106)),
    ("Cond ey tail", (512, 8, 8, 64), (64, 128, 128, 106)),
    ("Cond ex tail", (512, 8, 8, 128), (128, 128, 128, 424)),
    ("VAE enc tail", (1, 8, 8, 64), (64, 128, 128, 84)),
    ("VAE enc tail", (512, 8, 8, 64), (64, 128, 128, 84)),
]


class ChainCalls:
    """Records ``(x shape, later widths)`` of every chain the models route
    while it is open, by standing in for the wrapper that ``tail_chain``
    calls; calls routed to the plain version are recorded apart."""

    def __enter__(self):
        from simple_vae_rs_tpu_torch.ops import fused_chain as fch

        self.fch, self.orig = fch, fch.fused_conv3x3_chain
        self.calls, self.plain_calls = [], []

        def recording(x, kernels, biases, plain=False):
            key = (tuple(x.shape), tuple(k.shape[-1] for k in kernels))
            (self.plain_calls if plain else self.calls).append(key)
            return self.orig(x, kernels, biases, plain=plain)

        fch.fused_conv3x3_chain = recording
        return self

    def __exit__(self, *exc):
        self.fch.fused_conv3x3_chain = self.orig


def check_chain(shape, widths, seed, timing: bool):
    """The chain kernel vs its plain version at one shape; with ``timing``
    also the times of the chain, of the per-layer kernel launches it
    replaces, of the plain version and of one cuDNN call per layer."""
    from simple_vae_rs_tpu_torch.ops import fused_chain as fch
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    chans = (shape[-1],) + tuple(widths)
    x = torch.randn(shape, generator=gen, device="cuda")
    ks = [torch.randn((3, 3, chans[i], chans[i + 1]), generator=gen, device="cuda")
          / math.sqrt(9 * chans[i]) for i in range(len(widths))]
    bs = [torch.randn((c,), generator=gen, device="cuda") for c in widths]
    got = fch.fused_conv3x3_chain(x, ks, bs)
    want = fch.conv3x3_chain_plain(x, ks, bs)
    torch.cuda.synchronize()
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    if not (err <= KERNEL_TOL * ref) or not torch.isfinite(got).all():
        raise AssertionError(f"chain {shape}->{widths}: max|diff| {err} > {KERNEL_TOL} * {ref}")
    if tuple(got.shape) != tuple(shape[:3]) + (widths[-1],):
        raise AssertionError(f"chain {shape}->{widths}: output shape {tuple(got.shape)}")
    plan = fch.plan_chain(*shape[:3], chans)
    row = {"name": fc.CHAIN, "x": list(shape), "widths": list(widths), "max_abs_err": err,
           "max_abs_ref": ref, "plan": plan_text(shape[0], plan),
           "shared_memory_bytes": plan.smem_bytes}
    if not timing:
        return row
    ones = [torch.ones(c, device="cuda") for c in widths]

    def per_layer():
        h = x
        for k, one, b in zip(ks, ones, bs):
            h = fc.fused_conv3x3_bn_relu(h, k, one, b, relu=False)
        return h

    xn = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    wts = [k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for k in ks]

    def library():
        h = xn
        for wt, b in zip(wts, bs):
            h = F.conv2d(h, wt, b, padding=1)
        return h

    for what, other in (("per-layer kernels", per_layer()),
                        ("library calls", library().permute(0, 2, 3, 1))):
        other_err = float((other - want).abs().max())
        if not other_err <= KERNEL_TOL * ref:
            raise AssertionError(f"chain {shape}: the {what} disagree by {other_err}")
    before = dict(fc.launches)
    first = cuda_ms(lambda: fch.fused_conv3x3_chain(x, ks, bs), 1)
    reps = max(3, min(50, int(30.0 / max(first, 1e-3))))
    row["ms"] = cuda_ms(lambda: fch.fused_conv3x3_chain(x, ks, bs), reps)
    row["per_layer_ms"] = cuda_ms(per_layer, reps)
    row["plain_ms"] = cuda_ms(lambda: fch.conv3x3_chain_plain(x, ks, bs), reps)
    row["library4_ms"] = cuda_ms(library, reps)
    row["library_ms"] = None  # no single PyTorch call computes the chain
    for name, count in before.items():  # timing launches are not a path's launches
        fc.launches[name] = count
    pixels = shape[0] * shape[1] * shape[2]
    flops = 2.0 * 9 * pixels * sum(chans[i] * chans[i + 1] for i in range(len(widths)))
    nbytes = 4.0 * (x.numel() + got.numel() + sum(k.numel() for k in ks) + sum(widths))
    # the chain runs on the 3xTF32 tensor cores: its bound is theirs, the
    # CUDA-core figure beside
    bound_row(row, flops, nbytes, PEAK_F32_TC_FLOPS)
    row["bound_tc_ms"] = row["bound_ms"]
    row["bound_cuda_core_ms"] = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    row["share_of_bound_tc"] = row["bound_ms"] / row["ms"]
    return row


def plan_text(batch, plan):
    """A chain plan in a line: strips and panels a block, rows a step, blocks."""
    return (f"strip {plan.strip} x panel {plan.panel}, {plan.rs} rows a step, "
            f"{batch * plan.strips * plan.panels} blocks, {plan.smem_bytes} B")


class ChainRows:
    """Per-shape rows of the chain kernel (checked and timed once each)."""

    def __init__(self, report):
        self.rows, self.report = {}, report

    def row(self, shape, widths, site=""):
        key = (tuple(shape), tuple(widths))
        if key not in self.rows:
            row = self.rows[key] = check_chain(shape, widths, seed=900 + len(self.rows), timing=True)
            row["site"] = site
            self.report.append(row)
            log(f"chain shape {site} x{tuple(shape)}->{tuple(widths)} ({row['plan']}): chain "
                f"{row['ms']:.4f} ms, the {len(widths)} per-layer kernel launches "
                f"{row['per_layer_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"{len(widths)} library calls {row['library4_ms']:.4f} ms, 3xTF32 bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                f"{100 * row['share_of_bound_tc']:.1f}% of it), CUDA-core bound "
                f"{row['bound_cuda_core_ms']:.4f} ms, max|diff| {row['max_abs_err']:.2e}")
        return self.rows[key]


def expect_counts(what, got, want):
    got = {k: v for k, v in got.items() if v or k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def served_ok(what, out, shape):
    if tuple(out.shape) != shape or not torch.isfinite(out).all():
        raise AssertionError(f"{what}: output {tuple(out.shape)} is wrong")
    if float(out.min()) < 0 or float(out.max()) > 1:
        raise AssertionError(f"{what}: output leaves [0, 1]")


def chain_phase(report, model, sr, y, f32_out, f32_uq):
    """Phases C1, C2 and C5; returns the per-shape rows and the chains each
    path launched, as ``(x shape, later widths)``."""
    from simple_vae_rs_tpu_torch import SuperResolver
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    chain_report = report["chain"] = {"ragged": [], "shapes": []}
    # C1. ragged shapes, then every chain of the canonical models (timed: C5)
    for i, (shape, widths) in enumerate(RAGGED_CHAIN):
        row = check_chain(shape, widths, seed=850 + i, timing=False)
        chain_report["ragged"].append(row)
        log(f"ragged chain x{shape}->{widths} ({row['plan']}): max|diff| "
            f"{row['max_abs_err']:.3e}")
    rows = ChainRows(chain_report["shapes"])
    for site, shape, widths in CHAIN_SHAPES:
        rows.row(shape, widths, site)

    # C2. chained serving of the canonical Cond_SRVAE, float32
    by_path = {}
    src = SuperResolver(model, device="cuda", seed=0, chain=True)
    if model.chain or not src.model.chain:
        raise AssertionError("chain=True must switch the chain on in its own copy of the model")
    calls = []
    hooks = record_routed_calls(src.model, calls)
    with ChainCalls() as chained:
        reset_all_counts()
        out, uq, sr_ms, uq_ms, after_sr, n_sr_calls = serve_requests(src, y, calls)
        counts = all_counts()
    for h in hooks:
        h.remove()
    per_request = {"fused_conv3x3_bn_relu": 16, fc.CHAIN: 2, "fused_conv4x4s2_bn_relu": 5,
                   "fused_convT4x4s2_bn_relu": 3}
    expect_counts("chained super_resolve", after_sr, per_request)
    expect_counts("chained uncertainty", {k: counts[k] - after_sr[k] for k in counts},
                  per_request)
    u, z = model.config.u_channels, model.config.z_channels
    ey = (64, 128, 128, 2 * u)
    if chained.calls != [((16, 8, 8, 64), ey), ((16, 64, 64, 64), TAIL), ((1, 8, 8, 64), ey),
                         ((1000, 64, 64, 64), TAIL)] or chained.plain_calls:
        raise AssertionError(f"chained serving routed the chains {chained.calls}")
    for name in per_request:
        recorded = (len(chained.calls) if name == fc.CHAIN
                    else sum(1 for c in calls if c[0] == name))
        if recorded != counts[name]:
            raise AssertionError(f"chained serving {name}: {counts[name]} launches, {recorded} calls")
    prior = [c for c in calls[n_sr_calls:] if c[1][0] == 1]
    decode = [c for c in calls[n_sr_calls:] if c[1][0] == 1000]
    split = {"prior": {k: sum(1 for c in prior if c[0] == k) for k in per_request},
             "decode": {k: sum(1 for c in decode if c[0] == k) for k in per_request}}
    split["prior"][fc.CHAIN] = split["decode"][fc.CHAIN] = 1
    want_split = {"prior": {"fused_conv3x3_bn_relu": 13, fc.CHAIN: 1, "fused_conv4x4s2_bn_relu": 5,
                            "fused_convT4x4s2_bn_relu": 0},
                  "decode": {"fused_conv3x3_bn_relu": 3, fc.CHAIN: 1, "fused_conv4x4s2_bn_relu": 0,
                             "fused_convT4x4s2_bn_relu": 3}}
    if split != want_split:
        raise AssertionError(f"chained uncertainty launched {split}, expected {want_split}")
    by_path["serving_chained"] = chained.calls
    log("chained serving launches: super_resolve(16) "
        + " ".join(f"{k}={v}" for k, v in after_sr.items() if v) + " | uncertainty(1000) prior "
        + " ".join(f"{k}={v}" for k, v in split["prior"].items() if v) + ", decode "
        + " ".join(f"{k}={v}" for k, v in split["decode"].items() if v))

    blocks.use_plain_path(src.model)
    with ChainCalls() as plain_chained:
        before = all_counts()
        plain_sr = src.super_resolve(y, seed=11)
        plain_uq = src.uncertainty(y[0], samples=1000, seed=12)
        torch.cuda.synchronize()
    if all_counts() != before or plain_chained.calls or len(plain_chained.plain_calls) != 4:
        raise AssertionError("the chained plain path launched a kernel")
    blocks.use_plain_path(src.model, False)
    serve_err = {}
    for other, o_sr, o_uq in (("unchained", f32_out, f32_uq), ("plain", plain_sr, plain_uq)):
        serve_err[other] = {"super_resolve": float((out - o_sr).abs().max()),
                            "uncertainty.mean": float((uq["mean"] - o_uq["mean"]).abs().max()),
                            "uncertainty.std": float((uq["std"] - o_uq["std"]).abs().max())}
        for key, err in serve_err[other].items():
            if not err <= SERVE_TOL:
                raise AssertionError(f"chained {key} vs the {other} path: max|diff| {err} > "
                                     f"{SERVE_TOL}")
    log(f"chained serving max|diff| vs the unchained resolver {serve_err['unchained']}, vs the "
        f"plain path {serve_err['plain']}")
    del plain_sr, plain_uq

    # C2. W8A8 with the chain: the model carries int8 weights, so no tail chains
    sr8 = SuperResolver(model, device="cuda", seed=0, int8=True)
    sr8c = SuperResolver(model, device="cuda", seed=0, int8=True, chain=True)
    calls8 = []
    hooks = record_routed_calls(sr8c.model, calls8)
    with ChainCalls() as chained8:
        reset_all_counts()
        out8, uq8, _, _, after_sr8, _ = serve_requests(sr8c, y, calls8)
        counts8 = all_counts()
    for h in hooks:
        h.remove()
    # a model with int8 weights chains no tail (the JAX tail_chain's rule):
    # the W8A8 resolver's launches, unchanged
    want8 = dict(INT8_EXPECTED)
    expect_counts("W8A8 chained super_resolve", after_sr8, want8)
    expect_counts("W8A8 chained uncertainty", {k: counts8[k] - after_sr8[k] for k in counts8}, want8)
    if chained8.calls or chained8.plain_calls:
        raise AssertionError(f"W8A8 chained serving routed the chains {chained8.calls}")
    ref8 = sr8.super_resolve(y, seed=11)
    ref8_uq = sr8.uncertainty(y[0], samples=1000, seed=12)
    err8 = {"super_resolve": float((out8 - ref8).abs().max()),
            "uncertainty.mean": float((uq8["mean"] - ref8_uq["mean"]).abs().max())}
    for key, err in err8.items():
        if not err <= INT8_SERVE_TOL:
            raise AssertionError(f"W8A8 chained {key} vs W8A8 unchained: max|diff| {err}")
    by_path["serving_int8_chained"] = chained8.calls
    log("W8A8 chained serving launches per request: "
        + " ".join(f"{k}={v}" for k, v in after_sr8.items() if v)
        + f"; max|diff| vs the unchained W8A8 resolver {err8}")

    # C5. latencies, chained beside unchained, in turns
    lat = {}
    for mode, plain_r, chain_r in (("f32", sr, src), ("w8a8", sr8, sr8c)):
        t = {k: [] for k in ("sr", "sr_chain", "uq", "uq_chain")}
        for _ in range(5):
            t["sr"].append(timed(lambda: plain_r.super_resolve(y, seed=11))[1])
            t["sr_chain"].append(timed(lambda: chain_r.super_resolve(y, seed=11))[1])
        for _ in range(3):
            t["uq"].append(timed(lambda: plain_r.uncertainty(y[0], samples=1000, seed=12))[1])
            t["uq_chain"].append(timed(lambda: chain_r.uncertainty(y[0], samples=1000,
                                                                   seed=12))[1])
        lat[mode] = t
        log(f"{mode} super_resolve B=16: unchained median {statistics.median(t['sr']):.2f} ms, "
            f"chained {statistics.median(t['sr_chain']):.2f} ms; uncertainty N=1000: unchained "
            f"{statistics.median(t['uq']):.2f} ms, chained {statistics.median(t['uq_chain']):.2f} ms")
    chain_report["serving"] = {
        "super_resolve_b16_ms": sr_ms, "uncertainty_n1000_ms": uq_ms, "latency_ms": lat,
        "launches": counts, "launches_super_resolve_b16": after_sr, "uncertainty_split": split,
        "max_abs_err": serve_err, "w8a8_launches_per_request": after_sr8,
        "w8a8_max_abs_err_vs_unchained": err8,
    }
    return rows, by_path


def count_step(trainer, step, batch):
    """One counted step: conv and row launches by kernel and role, the chains
    it routed and the calls hooks recorded."""
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    calls = []
    hooks = record_conv_calls(trainer.model, calls)
    with ChainCalls() as chained:
        fc.reset_launches()
        fe.reset_launches()
        terms = getattr(trainer, step)(batch)
        torch.cuda.synchronize()
        roles = {k: dict(v) for k, v in fc.role_launches.items()}
        rows = {k: v for k, v in fe.launches.items() if v}
        chain_count = fc.launches[fc.CHAIN]
    for h in hooks:
        h.remove()
    recorded = counts_by_role(calls)
    for name, by_role in roles.items():
        for role, count in by_role.items():
            if recorded.get((name, role), 0) != count:
                raise AssertionError(f"{step}: {name} {role} launched {count} times, hooks "
                                     f"recorded {recorded.get((name, role), 0)}")
    if chain_count != len(chained.calls) or chained.plain_calls:
        raise AssertionError(f"{step}: {chain_count} chain launches, {chained.calls} routed")
    if not all(torch.isfinite(v) for v in terms.values()):
        raise AssertionError(f"{step}: non-finite loss terms {terms}")
    return terms, roles, rows, chained.calls


def flat_roles(roles):
    return {f"{name} {role}": n for name, by_role in roles.items() for role, n in by_role.items()
            if n}


def families_phase(report):
    """Phases C3 and C4: the chained val step of the canonical Cond_SRVAE, and
    the canonical VAE and SRVAE, served and trained. Returns the chains each
    path launched, as ``(x shape, later widths)``, and the other kernels'
    launches on the new paths."""
    from simple_vae_rs_tpu_torch import (SRVAE, VAE, CondSRVAE, CondSRVAEConfig, SuperResolver,
                                         TrainConfig, Trainer, VAEConfig)
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.tasks import auto_chunk, sample_chunked
    from simple_vae_rs_tpu_torch.models.srvae import box_downsample_2x
    from simple_vae_rs_tpu_torch.utils.image import normalize_image

    fam = report["families"] = {}
    by_path, others = {}, {}
    batch = training_batch()
    y, x = batch
    n = y.shape[0]
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    ey, ex = (64, 128, 128, 2 * cfg.u_channels), (128, 128, 128, 2 * cfg.z_channels)
    cond_chains = sorted([((n, 8, 8, 64), ey), ((n, 8, 8, 128), ex), ((n, 64, 64, 64), TAIL),
                          ((n, 32, 32, 64), TAIL)])

    # C3. Cond_SRVAE val step at B=512, unchained then chained
    model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
    randomize_bn(model, seed=1)
    trainer = Trainer(model, TrainConfig(learning_rate=LR), device="cuda")
    terms_u, roles_u, _, chains_u = count_step(trainer, "val_step", batch)
    blocks.use_chain(model)
    terms_c, roles_c, rows_c, chains_c = count_step(trainer, "val_step", batch)
    expect_counts("Cond val step", flat_roles(roles_u), {
        "fused_conv3x3_bn_relu forward": 37, "fused_conv4x4s2_bn_relu forward": 8,
        "fused_convT4x4s2_bn_relu forward": 5})
    expect_counts("Cond chained val step", flat_roles(roles_c), {
        "fused_conv3x3_bn_relu forward": 21, "fused_conv4x4s2_bn_relu forward": 8,
        "fused_convT4x4s2_bn_relu forward": 5})
    if chains_u or sorted(chains_c) != cond_chains:
        raise AssertionError(f"Cond val step routed the chains {chains_u} and {chains_c}")
    rel = {k: abs(float(terms_c[k] - v)) / max(abs(float(v)), 1e-30) for k, v in terms_u.items()}
    if not max(rel.values()) <= TERMS_TOL:
        raise AssertionError(f"Cond chained val step terms differ: {rel}")
    val_ms = {"unchained": [], "chained": []}
    for _ in range(3):
        blocks.use_chain(model, False)
        val_ms["unchained"].append(timed(lambda: trainer.val_step(batch))[1])
        blocks.use_chain(model)
        val_ms["chained"].append(timed(lambda: trainer.val_step(batch))[1])
    by_path["cond_val_step_chained"] = chains_c
    log(f"Cond val step B={n}: launches {flat_roles(roles_u)} unchained; chained "
        f"{flat_roles(roles_c)} {fc.CHAIN}={len(chains_c)} rows {rows_c}; terms rel "
        f"{max(rel.values()):.2e}; median {statistics.median(val_ms['unchained']):.2f} ms "
        f"unchained, {statistics.median(val_ms['chained']):.2f} ms chained")
    fam["cond_val_step"] = {"launches_unchained": roles_u, "launches_chained": roles_c,
                            "chain_launches": len(chains_c), "terms_rel": rel, "ms": val_ms}
    del trainer, model

    # C4. the canonical VAE: the N-draw decode of one window
    vcfg = VAEConfig(cr=1.5, patch_size=32)
    vae = VAE(vcfg, device="cuda").init_weights(seed=0)
    randomize_bn(vae, seed=2)
    n_params = sum(p.numel() for name, p in vae.named_parameters() if name != "gamma")
    if n_params != 805_562:
        raise AssertionError(f"canonical VAE has {n_params} parameters")
    log(f"model: VAE cr={vcfg.cr} ps={vcfg.patch_size} latent_channels={vcfg.latent_channels} "
        f"params={n_params} (+1 gamma)")
    vae.eval()
    window = y[:1]
    samples = 1000
    chunk = auto_chunk(samples, vcfg.patch_size)
    eps = torch.randn((samples, vcfg.latent_dim), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(21))
    enc, dec = (64, 128, 128, 2 * vcfg.latent_channels), TAIL
    draws = {}
    for mode in ("unchained", "chained", "plain"):
        blocks.use_chain(vae, mode != "unchained")
        blocks.use_plain_path(vae, mode == "plain")
        calls = []
        hooks = record_routed_calls(vae, calls)
        with ChainCalls() as chained:
            reset_all_counts()
            draws[mode], ms = timed(lambda: sample_chunked(vae, window, samples=samples,
                                                           chunk=chunk, eps_z=eps))
            counts = {k: v for k, v in all_counts().items() if v}
        for h in hooks:
            h.remove()
        want = {"unchained": {"fused_conv3x3_bn_relu": 12, "fused_conv4x4s2_bn_relu": 2,
                              "fused_convT4x4s2_bn_relu": 2},
                "chained": {"fused_conv3x3_bn_relu": 4, fc.CHAIN: 1 + -(-samples // chunk),
                            "fused_conv4x4s2_bn_relu": 2, "fused_convT4x4s2_bn_relu": 2},
                "plain": {}}[mode]
        expect_counts(f"VAE sample_chunked {mode}", counts, want)
        if mode == "chained" and chained.calls != [((1, 8, 8, 64), enc)] + [
                ((min(chunk, samples), 32, 32, 64), dec)] * -(-samples // chunk):
            raise AssertionError(f"VAE sample_chunked routed the chains {chained.calls}")
        if mode != "plain" and sum(counts.values()) - counts.get(fc.CHAIN, 0) != len(calls):
            raise AssertionError(f"VAE sample_chunked {mode}: {counts} launches, "
                                 f"{len(calls)} conv calls")
        served_ok(f"VAE sample_chunked {mode}", draws[mode], (samples, 32, 32, 4))
        fam[f"vae_sample_chunked_{mode}"] = {"launches": counts, "first_ms": ms}
        if mode == "chained":
            by_path["vae_sample_chunked"] = chained.calls
            others["vae_sample_chunked"] = {k: v for k, v in counts.items() if k != fc.CHAIN}
    blocks.use_plain_path(vae, False)
    if not float(draws["chained"].std(dim=0).max()) > 0:
        raise AssertionError("VAE draws do not differ")
    vae_err = {k: float((draws["chained"] - draws[k]).abs().max()) for k in ("unchained", "plain")}
    if not max(vae_err.values()) <= SERVE_TOL:
        raise AssertionError(f"VAE sample_chunked chained vs {vae_err}")
    vae_ms = {"unchained": [], "chained": []}
    for _ in range(3):
        for mode in vae_ms:
            blocks.use_chain(vae, mode == "chained")
            vae_ms[mode].append(timed(lambda: sample_chunked(vae, window, samples=samples,
                                                             chunk=chunk, eps_z=eps))[1])
    log(f"VAE sample_chunked N={samples} (chunk {chunk}): chained max|diff| vs unchained and "
        f"plain {vae_err}; median {statistics.median(vae_ms['unchained']):.2f} ms unchained, "
        f"{statistics.median(vae_ms['chained']):.2f} ms chained")
    fam["vae_sample_chunked"] = {"max_abs_err": vae_err, "ms": vae_ms}
    del draws

    # C4. the VAE's train and val step at B=512 (it trains on the LR stream)
    vae_state = copy.deepcopy(VAE(vcfg, device="cuda").init_weights(seed=0).state_dict())
    vae = VAE(vcfg, device="cuda")
    vae.load_state_dict(vae_state)
    blocks.use_chain(vae)
    trainer = Trainer(vae, TrainConfig(learning_rate=LR), device="cuda")
    _, roles_t, rows_t, chains_t = count_step(trainer, "train_step", batch)
    _, roles_v, rows_v, chains_v = count_step(trainer, "val_step", batch)
    expect_counts("VAE train step", {**flat_roles(roles_t), **rows_t}, {
        "fused_conv3x3_bn_relu forward": 12, "fused_conv3x3_bn_relu dx": 11,
        "fused_conv4x4s2_bn_relu forward": 2, "fused_conv4x4s2_bn_relu dx": 2,
        "fused_convT4x4s2_bn_relu forward": 2, "fused_convT4x4s2_bn_relu dx": 2,
        "sq_rows": 1, "kl_std_rows": 1})
    expect_counts("VAE chained val step", {**flat_roles(roles_v), **rows_v}, {
        "fused_conv3x3_bn_relu forward": 4, "fused_conv4x4s2_bn_relu forward": 2,
        "fused_convT4x4s2_bn_relu forward": 2, "sq_rows": 1, "kl_std_rows": 1})
    if chains_t or chains_v != [((n, 8, 8, 64), enc), ((n, 32, 32, 64), dec)]:
        raise AssertionError(f"VAE steps routed the chains {chains_t} and {chains_v}")
    timed(lambda: trainer.train_step(batch))
    step_ms = [timed(lambda: trainer.train_step(batch))[1] for _ in range(5)]
    by_path["vae_val_step"] = chains_v
    others["vae_train_step"] = {**flat_roles(roles_t), **rows_t}
    others["vae_val_step"] = {**flat_roles(roles_v), **rows_v}
    log(f"VAE train step B={n} launches: {others['vae_train_step']}; val step: "
        f"{others['vae_val_step']} {fc.CHAIN}={len(chains_v)}; train step median "
        f"{statistics.median(step_ms):.2f} ms, {n / (statistics.median(step_ms) / 1e3):.1f} "
        f"patches/s")
    del trainer, vae
    cmp = kernels_vs_plain(lambda: VAE(vcfg, device="cuda"), vae_state, batch,
                           label="VAE train step", chain=True)
    if cmp["failures"] or cmp["val_chain_launches"] != 2:
        raise AssertionError("VAE kernels vs plain path: " + "; ".join(cmp["failures"]))
    fam["vae_training"] = {"step_ms": step_ms, "launches_train_step": others["vae_train_step"],
                           "launches_val_step": others["vae_val_step"], "kernels_vs_plain": cmp}

    # C4. the canonical SRVAE: served from HR-sized and LR-sized input, one train step
    srvae = SRVAE(cfg, device="cuda").init_weights(seed=0)
    srvae_state = copy.deepcopy(srvae.state_dict())
    randomize_bn(srvae, seed=1)
    srs = SuperResolver(srvae, device="cuda", seed=0, chain=True)
    hr = x[:16] * 1000.0  # unnormalised, as a request's tiles arrive
    lr_of_hr = box_downsample_2x(normalize_image(hr)).contiguous()
    per_request = {"fused_conv3x3_bn_relu": 16, fc.CHAIN: 2, "fused_conv4x4s2_bn_relu": 5,
                   "fused_convT4x4s2_bn_relu": 3}
    outs = {}
    for what, inp, kw in (("hr", hr, {}), ("lr", lr_of_hr, {"normalize": False})):
        with ChainCalls() as chained:
            reset_all_counts()
            outs[what], ms = timed(lambda: srs.super_resolve(inp, seed=31, **kw))
            counts = {k: v for k, v in all_counts().items() if v}
        expect_counts(f"SRVAE super_resolve from {what.upper()} input", counts, per_request)
        if chained.calls != [((16, 8, 8, 64), ey), ((16, 64, 64, 64), TAIL)]:
            raise AssertionError(f"SRVAE super_resolve routed the chains {chained.calls}")
        served_ok(f"SRVAE super_resolve from {what.upper()} input", outs[what], (16, 64, 64, 4))
        fam[f"srvae_super_resolve_{what}"] = {"launches": counts, "first_ms": ms}
        by_path[f"srvae_super_resolve_{what}"] = chained.calls
    blocks.use_plain_path(srs.model)
    plain = srs.super_resolve(hr, seed=31)
    blocks.use_plain_path(srs.model, False)
    srvae_err = {"hr_vs_its_lr_view": float((outs["hr"] - outs["lr"]).abs().max()),
                 "vs_plain_path": float((outs["hr"] - plain).abs().max())}
    if not max(srvae_err.values()) <= SERVE_TOL:
        raise AssertionError(f"SRVAE super_resolve: {srvae_err}")
    rep = {k: [timed(lambda: srs.super_resolve(inp, seed=31, **kw))[1] for _ in range(5)]
           for k, inp, kw in (("hr", hr, {}), ("lr", lr_of_hr, {"normalize": False}))}
    log(f"SRVAE super_resolve B=16 chained: launches {counts}; from HR input median "
        f"{statistics.median(rep['hr']):.2f} ms, from LR input {statistics.median(rep['lr']):.2f} "
        f"ms; max|diff| {srvae_err}")
    fam["srvae_super_resolve"] = {"max_abs_err": srvae_err, "ms": rep}
    del srs, srvae, outs, plain

    srvae = SRVAE(cfg, device="cuda")
    srvae.load_state_dict(srvae_state)
    blocks.use_chain(srvae)
    trainer = Trainer(srvae, TrainConfig(learning_rate=LR), device="cuda")
    _, roles_t, rows_t, chains_t = count_step(trainer, "train_step", batch)
    _, roles_v, rows_v, chains_v = count_step(trainer, "val_step", batch)
    expect_counts("SRVAE train step", {**flat_roles(roles_t), **rows_t}, {
        "fused_conv3x3_bn_relu forward": 37, "fused_conv3x3_bn_relu dx": 34,
        "fused_conv4x4s2_bn_relu forward": 8, "fused_conv4x4s2_bn_relu dx": 5,
        "fused_convT4x4s2_bn_relu forward": 5, "fused_convT4x4s2_bn_relu dx": 8,
        "sq_rows": 2, "kl_std_rows": 1, "kl_gen_rows": 1})
    expect_counts("SRVAE chained val step", {**flat_roles(roles_v), **rows_v}, {
        "fused_conv3x3_bn_relu forward": 21, "fused_conv4x4s2_bn_relu forward": 8,
        "fused_convT4x4s2_bn_relu forward": 5, "sq_rows": 2, "kl_std_rows": 1, "kl_gen_rows": 1})
    if chains_t or sorted(chains_v) != cond_chains:
        raise AssertionError(f"SRVAE steps routed the chains {chains_t} and {chains_v}")
    timed(lambda: trainer.train_step(batch))
    step_ms = [timed(lambda: trainer.train_step(batch))[1] for _ in range(3)]
    by_path["srvae_val_step"] = chains_v
    others["srvae_train_step"] = {**flat_roles(roles_t), **rows_t}
    others["srvae_val_step"] = {**flat_roles(roles_v), **rows_v}
    log(f"SRVAE train step B={n} launches: {others['srvae_train_step']}; val step: "
        f"{others['srvae_val_step']} {fc.CHAIN}={len(chains_v)}; train step median "
        f"{statistics.median(step_ms):.2f} ms")
    del trainer, srvae
    cmp = kernels_vs_plain(lambda: SRVAE(cfg, device="cuda"), srvae_state, batch,
                           label="SRVAE train step", chain=True)
    if cmp["failures"] or cmp["val_chain_launches"] != 4:
        raise AssertionError("SRVAE kernels vs plain path: " + "; ".join(cmp["failures"]))
    fam["srvae_training"] = {"step_ms": step_ms, "launches_train_step": others["srvae_train_step"],
                             "launches_val_step": others["srvae_val_step"],
                             "kernels_vs_plain": cmp}
    return by_path, others


# ------------------------------------------------------------------ bfloat16
PEAK_BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
BF16_SOURCE_TAG = "_bf16"  # the kernels line's name of a bfloat16 instance
WG_SOURCE = "simple_vae_rs_tpu_torch/csrc/conv_wg.cu"
# conv_wg_bf16 at shapes it takes (C % 8 == 0, O % 8 == 0) with the edges of
# its plan: C % 64 != 0 (72, 200: zero-filled channels), C = 16 (16-channel
# k-groups), O = 8 and 24 (a 16-wide and a part-filled 64-wide channel tile),
# O = 136 (a last 128-wide tile of 8), odd H and W, a batch that is not a
# multiple of the box's images, a row wider than one 128-pixel box, a box of
# whole images (4x4, 8x8), both roles; #5 on an 8x8 and a 4x4 output grid, an
# odd output grid and a 128-wide output row (its strided box at TMA's
# 256-element limit), with C = 72, 424 and 16 and O = 8, 24 and 136
RAGGED_WG = [
    ("fused_conv3x3_bn_relu", (3, 9, 11, 72), 24, True),
    ("fused_conv3x3_bn_relu", (2, 6, 7, 200), 8, False),
    ("fused_conv3x3_bn_relu", (11, 4, 4, 64), 136, True),
    ("fused_conv3x3_bn_relu", (3, 8, 8, 128), 64, True),
    ("fused_conv3x3_bn_relu", (2, 3, 150, 32), 32, True),
    ("fused_conv3x3_bn_relu", (2, 64, 64, 64), 16, True),
    ("fused_convT4x4s2_bn_relu", (3, 5, 6, 72), 24, False),
    ("fused_convT4x4s2_bn_relu", (3, 8, 8, 200), 136, True),
    ("fused_convT4x4s2_bn_relu", (11, 4, 4, 64), 8, True),
    ("fused_convT4x4s2_bn_relu", (2, 16, 16, 128), 64, True),
    ("fused_convT4x4s2_bn_relu", (3, 6, 8, 16), 128, False),
    ("fused_conv3x3_bn_relu", (3, 8, 8, 16), 64, False),
    ("fused_conv4x4s2_bn_relu", (3, 16, 16, 72), 24, True),
    ("fused_conv4x4s2_bn_relu", (11, 8, 8, 64), 136, True),
    ("fused_conv4x4s2_bn_relu", (2, 6, 10, 16), 8, False),
    ("fused_conv4x4s2_bn_relu", (2, 4, 256, 32), 24, True),
    ("fused_conv4x4s2_bn_relu", (3, 16, 16, 424), 136, False),
    ("fused_conv4x4s2_bn_relu", (5, 32, 32, 128), 64, True),
]
# served outputs in [0, 1] through ~25 bfloat16 layers: the kernels and the
# plain path round float32 sums taken in other orders, so an activation may
# land one bfloat16 ulp (2^-8 relative) apart and carry that on
BF16_SERVE_TOL = 2e-2  # absolute
# PSNR of the bfloat16 resolver against the float32 one on the same noise: a
# pre-sigmoid value rounded to bfloat16 moves an output by ~1e-3 (60 dB); the
# floor leaves two orders of magnitude for the error carried through the
# network and is 10 dB above the int8 modes' 30
MIN_PSNR_BF16_DB = 40.0
# the bfloat16 step through the kernels against the plain path: loss terms
# and BatchNorm statistics 1e-2 relative (bfloat16 activations one ulp
# apart, averaged over the batch); each gradient leaf within 2x its own
# bfloat16 error (the plain path in float32 against the plain path in
# bfloat16, the noise rule of the CPU parity tests) + 1e-3 of its block's
# largest gradient: a bfloat16 gradient that cancels (a conv that BatchNorm
# follows) moves far more than an ulp when an activation flips, and the
# permuted batch, which moves float32 sums, rarely moves a bfloat16 one;
# parameters after the step within 2 * lr, and as large a share within
# 1e-2 * lr as the float32 step keeps from the bfloat16 plain step (Adam's
# first step is lr * sign(g): an element whose gradient is within the
# bfloat16 spread of 0 may take either sign)
BF16_STEP_TOLS = {"terms": 1e-2, "stats": 1e-2, "grad": 1e-3, "noise": 2.0,
                  "params_share": None}
# (kernel, role) that must run conv_wg_bf16 in the serving run and in the
# bfloat16 train step: #1 and #6 forward; #5 only in the step (the serving
# run's DownBlock tails are below its cut), in both roles: the input
# gradients of the UpBlocks' transposed convs and the HR DownBlock ex_down3
WG_SERVING_ROLES = (("fused_conv3x3_bn_relu", "forward"), ("fused_convT4x4s2_bn_relu", "forward"))
WG_STEP_ROLES = WG_SERVING_ROLES + (("fused_conv4x4s2_bn_relu", "forward"),
                                    ("fused_conv4x4s2_bn_relu", "dx"))


def check_shape_bf16(fc, name, shape, o, relu, seed, timing: bool, site=None, impl=None):
    """The bfloat16 instance vs its plain version at one shape (within one
    bfloat16 ulp plus 1e-4 of max|plain|: ``fc.compare_bf16``; the same bits
    on a second launch): through the wrapper's route, or with ``impl`` ("wg"
    or "tc") through that kernel (``fc.launch_bf16``). With ``timing`` also
    its time, the plain version's, one cuDNN call in bfloat16 and the float32
    kernel at the same shape; where ``conv_wg_bf16`` takes the shape, both
    bfloat16 kernels (each checked too) in turns, tc, wg, wg, tc, and ``ms``
    is the routed one's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if name == "fused_conv3x3_bn_relu" else 4
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    kernel = (torch.randn((k, k, c, o), generator=gen, device="cuda")
              / math.sqrt(k * k * c)).bfloat16()
    if site is None:
        scale = torch.rand((o,), generator=gen, device="cuda") + 0.5
        shift = torch.randn((o,), generator=gen, device="cuda")
    else:
        scale, shift = torch.ones(o, device="cuda"), torch.zeros(o, device="cuda")

    def through(which):
        if which is None:
            return lambda: getattr(fc, name)(x, kernel, scale, shift, relu=relu)
        return lambda: fc.launch_bf16(name, which, x, kernel, scale, shift, relu)

    fn = through(impl)
    got = fn()
    want = fc.PLAIN[name](x, kernel, scale, shift, relu)
    torch.cuda.synchronize()
    cmp = fc.compare_bf16(got, want)
    if got.dtype != torch.bfloat16 or not cmp["of_bound"] <= 1.0 or not torch.isfinite(got).all():
        raise AssertionError(f"bf16 {name} {shape}->{o} ({impl or 'routed'}): {cmp}")
    if not torch.equal(fn(), got):
        raise AssertionError(f"bf16 {name} {shape}->{o}: a second launch gave other bits")
    routed = "wg" if fc.wg_eligible(name, x, kernel) else "tc"
    row = {"name": name, "role": "forward" if site is None else "dx", "x": list(shape), "o": o,
           "relu": relu, "impl": impl or routed, **cmp}
    if timing:
        if site is None:
            lib = library_fn(name, x, kernel, scale, shift, relu)
        else:
            lib = library_dx(site, x, kernel)
        # the library call folds scale into bfloat16 weights, each rounded once
        # more, so it is only held to compute the same function: 2^-5 of max|plain|
        lib_cmp = fc.compare_bf16(lib().permute(0, 2, 3, 1), want)
        if not lib_cmp["max_abs_err"] <= 2.0**-5 * lib_cmp["max_abs_ref"]:
            raise AssertionError(f"bf16 library call disagrees at {name} {shape}: {lib_cmp}")
        xf, kf = x.float(), kernel.float()
        first = cuda_ms(fn, 1)
        reps = max(3, min(50, int(30.0 / max(first, 1e-3))))
        if fc.wg_supported(name, x, kernel):
            for which in ("tc", "wg"):
                other = fc.compare_bf16(through(which)(), want)
                if not other["of_bound"] <= 1.0:
                    raise AssertionError(f"bf16 {name} {shape}->{o} ({which}): {other}")
                row[f"{which}_of_bound"] = other["of_bound"]
            turns = [cuda_ms(through(which), reps) for which in ("tc", "wg", "wg", "tc")]
            row["turns_ms"] = turns
            row["tc_ms"], row["wg_ms"] = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            row["ms"] = row[f"{routed}_ms"]
        else:
            row["ms"] = row["tc_ms"] = cuda_ms(fn, reps)
            row["wg_ms"] = None
        row["plain_ms"] = cuda_ms(lambda: fc.PLAIN[name](x, kernel, scale, shift, relu), reps)
        row["library_ms"] = cuda_ms(lib, reps)
        row["f32_kernel_ms"] = cuda_ms(lambda: getattr(fc, name)(xf, kf, scale, shift, relu=relu),
                                       reps)
        m, n, kk, phases = fc.geometry(name, x, kernel)
        flops = 2.0 * phases * m * n * kk
        nbytes = 2.0 * (x.numel() + kernel.numel() + got.numel()) + 4.0 * 2 * o
        bound_row(row, flops, nbytes, PEAK_BF16_FLOPS)
        row["flops"] = flops
    return row


def check_input_grad_wg(fc, name, shape, o, seed):
    """``conv_wg_bf16`` in the dx role as the model paths reach it: kernel
    ``name`` run by ``fc.input_grad`` of the conv whose adjoint it is, on a
    bfloat16 gradient of that conv's output with ``shape``, the weight
    flip-swapped there into a fresh tensor, held to the plain route within
    ``fc.compare_bf16``'s bound, the same bits on a second launch."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 3 if name == "fused_conv3x3_bn_relu" else 4
    g = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    kernel = (torch.randn((k, k, shape[-1], o), generator=gen, device="cuda")
              / math.sqrt(k * k * shape[-1])).bfloat16()
    site, in_shape = fc.DX_KERNEL[name], fc.output_shape(name, shape, o)
    w_site = fc.flip_swap(kernel)  # input_grad flips it back into a new tensor
    got = fc.input_grad(site, g, w_site, in_shape, impl="wg")
    want = fc.input_grad(site, g, w_site, in_shape, plain=True)
    torch.cuda.synchronize()
    cmp = fc.compare_bf16(got, want)
    if tuple(got.shape) != tuple(in_shape) or not cmp["of_bound"] <= 1.0:
        raise AssertionError(f"bf16 wg input_grad of {site} via {name} {shape}->{o}: {cmp}")
    if not torch.equal(fc.input_grad(site, g, w_site, in_shape, impl="wg"), got):
        raise AssertionError(f"bf16 wg input_grad {name} {shape}: a second launch gave other bits")
    return cmp


def bf16_counts(fc):
    """The bfloat16 launches by (kernel, role) since the last reset, and a
    check that no float32 conv kernel and no chain launched."""
    if any(fc.launches.values()):
        raise AssertionError(f"a float32 kernel launched on a bfloat16 path: {fc.launches}")
    return {(name, role): n for name, roles in fc.bf16_launches.items()
            for role, n in roles.items() if n}


def impl_counts(fc):
    """The bfloat16 #1/#5/#6 launches by (kernel, role, kernel that ran)
    since the last reset."""
    return {(name, role, impl): n for name, roles in fc.bf16_impl_launches.items()
            for role, impls in roles.items() for impl, n in impls.items() if n}


def check_impls(fc, what, calls):
    """The launches by kernel that ran against the static rule
    (``fc.wg_route`` of each recorded call's shapes; ``fc.plan_wg`` counts
    its tiles): they must be equal. Returns them."""
    want = {}
    for name, role, shape, o, *_ in calls:
        impl = "wg" if fc.wg_route(name, shape, o) else "tc"
        want[(name, role, impl)] = want.get((name, role, impl), 0) + 1
    got = impl_counts(fc)
    if got != want:
        raise AssertionError(f"{what}: launches by kernel {got}, the static rule says {want}")
    log(f"{what} launches by kernel: "
        + " ".join(f"{k[0]} {k[1]} {k[2]}={v}" for k, v in sorted(got.items())))
    return got


def conv4_by_role(fc, paths, per_key, key_of):
    """#5's bfloat16 launches of the serving run and the steps summed per
    role: launches by the kernel that ran, the routed kernels' time (and the
    part of it on each kernel), conv_tc_bf16's at every launch (the route
    before #5 moved to conv_wg_bf16), one cuDNN bfloat16 call's and the
    bound. Logged; returned for the report."""
    name = "fused_conv4x4s2_bn_relu"
    out = {}
    for role in fc.ROLES:
        rows = [per_key[key_of(c)] for _, cs in paths for c in cs if c[0] == name and c[1] == role]
        if not rows:
            continue
        d = {"launches": {impl: sum(r["impl"] == impl for r in rows) for impl in fc.IMPLS},
             **{f"{impl}_routed_ms": sum(r["ms"] for r in rows if r["impl"] == impl)
                for impl in fc.IMPLS},
             **{k: sum(r[k] for r in rows) for k in ("ms", "tc_ms", "library_ms", "bound_ms")}}
        out[role] = d
        log(f"bf16 {name} {role} role, serving + train step + val step: launches "
            + " ".join(f"{k}={v}" for k, v in d["launches"].items())
            + f"; kernels as routed {d['ms']:.3f} ms (on wg {d['wg_routed_ms']:.3f}, on tc "
            f"{d['tc_routed_ms']:.3f}), conv_tc_bf16 at every launch {d['tc_ms']:.3f} ms, cuDNN "
            f"bf16 {d['library_ms']:.3f} ms, bound {d['bound_ms']:.3f} ms (989 TFLOP/s, 3.35 TB/s)")
    return out


def bf16_phase(report, f32_out, f32_uq, f32_train_peak_gib):
    """Phase B: bfloat16 compute. Returns the kernels line's three bfloat16
    entries. Failures of the comparisons are collected and raised at the
    end, after every number is printed."""
    from simple_vae_rs_tpu_torch import (SRVAE, VAE, CondSRVAE, CondSRVAEConfig, SuperResolver,
                                         TrainConfig, Trainer, VAEConfig)
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe
    from simple_vae_rs_tpu_torch.tasks import sample_chunked

    bf = report["bf16"] = {"ragged": [], "shapes": []}
    failures = []
    # B1. ragged shapes, and C % 8 == 0 beside C % 8 != 0, both roles
    ragged = RAGGED + [
        ("fused_conv3x3_bn_relu", (4, 16, 16, 64), 64, True),
        ("fused_conv3x3_bn_relu", (4, 16, 16, 60), 64, True),
        ("fused_conv4x4s2_bn_relu", (4, 16, 16, 16), 64, True),
        ("fused_conv4x4s2_bn_relu", (4, 16, 16, 12), 64, True),
        ("fused_convT4x4s2_bn_relu", (4, 8, 8, 64), 16, True),
        ("fused_convT4x4s2_bn_relu", (4, 8, 8, 60), 16, True),
    ]
    for i, (name, shape, o, relu) in enumerate(ragged):
        row = check_shape_bf16(fc, name, shape, o, relu, seed=700 + i, timing=False)
        site = fc.DX_KERNEL[name]
        dx = check_shape_bf16(fc, name, shape, o, False, seed=800 + i, timing=False, site=site)
        bf["ragged"] += [row, dx]
        log(f"bf16 ragged {name} x{shape} O={o}: forward {row['of_bound']:.3f} of bound, "
            f"bit-equal {row['share_bit_equal']:.4f}, within 1 ulp {row['share_within_1ulp']:.6f};"
            f" dx {dx['of_bound']:.3f}, bit-equal {dx['share_bit_equal']:.4f}")
    # B1. conv_wg_bf16 at the ragged shapes it takes, both roles: through the
    # wrapper's operands and through input_grad's (the flip-swapped weight)
    for i, (name, shape, o, relu) in enumerate(RAGGED_WG):
        fc.reset_launches()
        row = check_shape_bf16(fc, name, shape, o, relu, seed=750 + i, timing=False, impl="wg")
        dx = check_shape_bf16(fc, name, shape, o, False, seed=850 + i, timing=False,
                              site=fc.DX_KERNEL[name], impl="wg")
        via = check_input_grad_wg(fc, name, shape, o, seed=950 + i)
        if (fc.bf16_impl_launches[name]["forward"] != {"wg": 4, "tc": 0}
                or fc.bf16_impl_launches[name]["dx"] != {"wg": 2, "tc": 0}):
            raise AssertionError(f"bf16 wg ragged {name} {shape}: launches by kernel "
                                 f"{fc.bf16_impl_launches[name]}")
        bf["ragged"] += [row, dx, {**dx, **via, "role": "dx", "via": "input_grad"}]
        log(f"bf16 wg ragged {name} x{shape} O={o} plan {tuple(fc.plan_wg(name, *shape, o))}: "
            f"forward {row['of_bound']:.3f} of bound, bit-equal {row['share_bit_equal']:.4f}; dx "
            f"{dx['of_bound']:.3f}, bit-equal {dx['share_bit_equal']:.4f}; through input_grad "
            f"{via['of_bound']:.3f}, bit-equal {via['share_bit_equal']:.4f}; the same bits twice")

    # B2. serving in bfloat16 at full width: the weights of phase 4's model
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    f32_model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
    randomize_bn(f32_model, seed=1)
    model = CondSRVAE(cfg, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(f32_model.state_dict())
    del f32_model
    sr = SuperResolver(model, device="cuda", seed=0)  # unchained (chained: B9)
    y = np.random.default_rng(2).random((16, cfg.lr_patch_size, cfg.lr_patch_size, 4),
                                        dtype=np.float32)
    sr.super_resolve(y, seed=0)
    sr.uncertainty(y[0], samples=8, seed=0)
    serve_calls = []
    hooks = record_conv_calls(sr.model, serve_calls)
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    out, sr_ms = timed(lambda: sr.super_resolve(y, seed=11))
    sr_counts = bf16_counts(fc)
    uq, uq_ms = timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))
    serve_counts = bf16_counts(fc)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    for h in hooks:
        h.remove()
    recorded = counts_by_role(serve_calls)
    if serve_counts != recorded or not serve_counts:
        raise AssertionError(f"bf16 serving launches {serve_counts}, hooks recorded {recorded}")
    serve_impls = check_impls(fc, "bf16 serving", serve_calls)
    for name, role in WG_SERVING_ROLES:
        if not serve_impls.get((name, role, "wg")):
            raise AssertionError(f"bf16 serving: {name} {role} never ran conv_wg_bf16")
    served_ok("bf16 super_resolve", out, (16, 64, 64, 4))
    if out.dtype != torch.float32 or any(v.dtype != torch.float32 for v in uq.values()):
        raise AssertionError("bf16 serving: outputs are not float32")
    for key in ("mean", "std", "variance"):
        if tuple(uq[key].shape) != (64, 64, 4) or not torch.isfinite(uq[key]).all():
            raise AssertionError(f"bf16 uncertainty[{key}] is wrong")
    rep_sr = [timed(lambda: sr.super_resolve(y, seed=11))[1] for _ in range(5)]
    rep_uq = [timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))[1] for _ in range(3)]
    blocks.use_plain_path(sr.model)
    before = bf16_counts(fc)
    plain_out = sr.super_resolve(y, seed=11)
    plain_uq = sr.uncertainty(y[0], samples=1000, seed=12)
    if bf16_counts(fc) != before:
        raise AssertionError("the bf16 plain path launched a kernel")
    blocks.use_plain_path(sr.model, False)
    serve_err = {"super_resolve": float((out - plain_out).abs().max()),
                 **{f"uncertainty.{k}": float((uq[k] - plain_uq[k]).abs().max())
                    for k in ("mean", "std")}}
    psnr = {"super_resolve": psnr_db(out, f32_out), "uncertainty.mean":
            psnr_db(uq["mean"], f32_uq["mean"])}
    for key, err in serve_err.items():
        if not err <= BF16_SERVE_TOL:
            failures.append(f"bf16 {key}: kernels vs plain path {err} > {BF16_SERVE_TOL}")
    for key, db in psnr.items():
        if not db >= MIN_PSNR_BF16_DB:
            failures.append(f"bf16 {key}: PSNR {db:.2f} dB against float32 < {MIN_PSNR_BF16_DB}")
    log("bf16 serving launches: super_resolve(16) "
        + " ".join(f"{k[0]}={v}" for k, v in sr_counts.items()) + " | with uncertainty(1000) "
        + " ".join(f"{k[0]}={v}" for k, v in serve_counts.items()) + " (float32 kernels 0)")
    log(f"bf16 super_resolve B=16: {sr_ms:.2f} ms (repeats median {statistics.median(rep_sr):.2f}"
        f" ms); uncertainty N=1000: {uq_ms:.2f} ms (repeats median "
        f"{statistics.median(rep_uq):.2f} ms); peak memory {serve_peak:.2f} GiB; kernels vs "
        f"plain path max|diff| {serve_err}; PSNR against float32 {psnr}")
    bf["serving"] = {"super_resolve_b16_ms": sr_ms, "super_resolve_b16_ms_repeats": rep_sr,
                     "uncertainty_n1000_ms": uq_ms, "uncertainty_n1000_ms_repeats": rep_uq,
                     "peak_memory_gib": serve_peak, "max_abs_err_vs_plain": serve_err,
                     "psnr_db_vs_f32": psnr,
                     "launches": {" ".join(k): v for k, v in serve_counts.items()},
                     "launches_by_kernel": {" ".join(k): v for k, v in serve_impls.items()}}
    del sr, model, plain_out, plain_uq

    # B3. one Cond_SRVAE training step at B=512, bf16_moments off then on
    batch = training_batch()
    n = batch[0].shape[0]
    init_state = copy.deepcopy(CondSRVAE(cfg, device="cuda").init_weights(seed=0).state_dict())
    train_calls, val_calls, steps = [], [], {}
    for moments in (False, True):
        model = CondSRVAE(cfg, device="cuda", dtype=torch.bfloat16)
        model.load_state_dict(init_state)
        tcfg = TrainConfig(learning_rate=LR, use_bfloat16=True, bf16_moments=moments)
        trainer = Trainer(model, tcfg, device="cuda")
        calls = []
        hooks = record_conv_calls(model, calls)
        fc.reset_launches()
        fe.reset_launches()
        terms = trainer.train_step(batch)
        torch.cuda.synchronize()
        counts, rows = bf16_counts(fc), dict(fe.launches)
        for h in hooks:
            h.remove()
        if counts != counts_by_role(calls) or rows != {"sq_rows": 2, "kl_std_rows": 1,
                                                       "kl_gen_rows": 1}:
            raise AssertionError(f"bf16 train step launches {counts} {rows}, hooks recorded "
                                 f"{counts_by_role(calls)}")
        step_impls = check_impls(fc, f"bf16 train step (moments={moments})", calls)
        for name, role in WG_STEP_ROLES:
            if not step_impls.get((name, role, "wg")):
                raise AssertionError(f"bf16 train step: {name} {role} never ran conv_wg_bf16")
        if not all(torch.isfinite(v) for v in terms.values()):
            raise AssertionError(f"bf16 train step: non-finite loss terms {terms}")
        if moments and not all(m.dtype == torch.bfloat16 for m in trainer.opt.mu):
            raise AssertionError("bf16_moments: Adam's first moment is not bfloat16")
        timed(lambda: trainer.train_step(batch))
        torch.cuda.reset_peak_memory_stats()
        step_ms = [timed(lambda: trainer.train_step(batch))[1] for _ in range(5)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not moments:
            train_calls = calls
            vcalls = []
            hooks = record_conv_calls(model, vcalls)
            fc.reset_launches()
            val = trainer.val_step(batch)
            torch.cuda.synchronize()
            val_counts = bf16_counts(fc)
            for h in hooks:
                h.remove()
            if val_counts != counts_by_role(vcalls):
                raise AssertionError(f"bf16 val step launches {val_counts}")
            check_impls(fc, "bf16 val step", vcalls)
            if not all(torch.isfinite(v) for v in val.values()):
                raise AssertionError(f"bf16 val step: non-finite loss terms {val}")
            val_calls = vcalls
            val_ms = [timed(lambda: trainer.val_step(batch))[1] for _ in range(3)]
        med = statistics.median(step_ms)
        steps[moments] = {"step_ms": step_ms, "step_ms_median": med, "peak_memory_gib": peak,
                          "patches_per_s": n / (med / 1e3),
                          "terms": {k: float(v) for k, v in terms.items()},
                          "launches": {" ".join(k): v for k, v in counts.items()},
                          "launches_by_kernel": {" ".join(k): v for k, v in step_impls.items()}}
        log(f"bf16 train step B={n} bf16_moments={moments}: median {med:.2f} ms over 5 ("
            + ", ".join(f"{t:.2f}" for t in step_ms) + f"), {n / (med / 1e3):.1f} patches/s, "
            f"peak memory {peak:.2f} GiB (float32 step {f32_train_peak_gib:.2f} GiB); launches "
            + " ".join(f"{k[0]} {k[1]}={v}" for k, v in counts.items())
            + "; terms " + " ".join(f"{k}={float(v):.4f}" for k, v in terms.items()))
        del trainer, model
        torch.cuda.empty_cache()
        cmp = kernels_vs_plain(lambda: CondSRVAE(cfg, device="cuda", dtype=torch.bfloat16),
                               init_state, batch, label=f"bf16 train step (moments={moments})",
                               train_cfg={"use_bfloat16": True, "bf16_moments": moments},
                               tols=BF16_STEP_TOLS, noise_model=lambda: CondSRVAE(cfg, device="cuda"))
        steps[moments]["kernels_vs_plain"] = cmp
        failures += [f"bf16_moments={moments}: {f}" for f in cmp["failures"]]
    log(f"bf16 val step B={n}: median {statistics.median(val_ms):.2f} ms; launches "
        + " ".join(f"{k[0]}={v}" for k, v in val_counts.items()))
    bf["training"] = {"moments_off": steps[False], "moments_on": steps[True], "val_step_ms": val_ms,
                      "launches_val_step": {" ".join(k): v for k, v in val_counts.items()}}

    # B4. the VAE and the SRVAE in bfloat16: one request and one train step each
    vcfg = VAEConfig(cr=1.5, patch_size=32)
    vae = VAE(vcfg, device="cuda", dtype=torch.bfloat16).init_weights(seed=0)
    trainer = Trainer(vae, TrainConfig(learning_rate=LR, use_bfloat16=True), device="cuda")
    family_calls = []
    hooks = record_conv_calls(vae, family_calls)
    fc.reset_launches()
    vterms = trainer.train_step(batch)
    vcounts = bf16_counts(fc)
    check_impls(fc, "bf16 VAE train step", family_calls)
    vae.eval()
    window = batch[0][:1]
    family_calls.clear()
    fc.reset_launches()
    draws, vae_ms = timed(lambda: sample_chunked(vae, window, torch.Generator(device="cuda")
                                                 .manual_seed(3), samples=1000, chunk=1000))
    vdraw_counts = bf16_counts(fc)
    check_impls(fc, "bf16 VAE sample_chunked(1000)", family_calls)
    for h in hooks:
        h.remove()
    # B9: the same request chained, through the chain's bfloat16 instance
    blocks.use_chain(vae)
    fc.reset_launches()
    draws_c, vae_c_ms = timed(lambda: sample_chunked(
        vae, window, torch.Generator(device="cuda").manual_seed(3), samples=1000, chunk=1000))
    vchain_counts = bf16_counts(fc)
    blocks.use_chain(vae, False)
    vae_chain_err = float((draws_c - draws).abs().max())
    if vchain_counts.get((fc.CHAIN, "forward")) != 2 or not vae_chain_err <= BF16_SERVE_TOL:
        raise AssertionError(f"bf16 VAE chained draws: launches {vchain_counts} (chain 2 expected:"
                             f" the encoder and the one decode chunk), max|diff| vs unchained "
                             f"{vae_chain_err}")
    blocks.use_plain_path(vae)
    plain_draws = sample_chunked(vae, window, torch.Generator(device="cuda").manual_seed(3),
                                 samples=1000, chunk=1000)
    vae_err = float((draws - plain_draws).abs().max())
    if draws.dtype != torch.float32 or not torch.isfinite(draws).all() or not all(
            torch.isfinite(v) for v in vterms.values()):
        raise AssertionError("bf16 VAE: non-finite or non-float32 results")
    if not vae_err <= BF16_SERVE_TOL:
        failures.append(f"bf16 VAE sample_chunked vs plain path {vae_err}")
    log(f"bf16 VAE train step B={n}: launches "
        + " ".join(f"{k[0]} {k[1]}={v}" for k, v in vcounts.items())
        + f"; sample_chunked N=1000: {vae_ms:.2f} ms (first call), launches "
        + " ".join(f"{k[0]}={v}" for k, v in vdraw_counts.items())
        + f", max|diff| vs plain path {vae_err:.3e}; chained {vae_c_ms:.2f} ms, launches "
        + " ".join(f"{k[0]}={v}" for k, v in vchain_counts.items())
        + f", max|diff| vs unchained {vae_chain_err:.3e}")
    del trainer, vae, draws, plain_draws, draws_c
    srvae = SRVAE(cfg, device="cuda", dtype=torch.bfloat16).init_weights(seed=0)
    srs = SuperResolver(srvae, device="cuda", seed=0)
    hr = batch[1][:16] * 1000.0
    family_calls.clear()
    hooks = record_conv_calls(srvae, family_calls)
    fc.reset_launches()
    s_out, s_ms = timed(lambda: srs.super_resolve(hr, seed=31))
    s_counts = bf16_counts(fc)
    check_impls(fc, "bf16 SRVAE super_resolve(16)", family_calls)
    for h in hooks:
        h.remove()
    served_ok("bf16 SRVAE super_resolve", s_out, (16, 64, 64, 4))
    # B9: the same request chained (the ey and dx tails, as C2's float32 counts)
    srs_c = SuperResolver(srvae, device="cuda", seed=0, chain=True)
    fc.reset_launches()
    s_c_out, s_c_ms = timed(lambda: srs_c.super_resolve(hr, seed=31))
    s_chain_counts = bf16_counts(fc)
    s_chain_err = float((s_c_out - s_out).abs().max())
    if s_chain_counts.get((fc.CHAIN, "forward")) != 2 or not s_chain_err <= BF16_SERVE_TOL:
        raise AssertionError(f"bf16 SRVAE chained super_resolve: launches {s_chain_counts}, "
                             f"max|diff| vs unchained {s_chain_err}")
    del srs_c
    trainer = Trainer(srvae, TrainConfig(learning_rate=LR, use_bfloat16=True), device="cuda")
    family_calls.clear()
    hooks = record_conv_calls(srvae, family_calls)
    fc.reset_launches()
    sterms = trainer.train_step(batch)
    st_counts = bf16_counts(fc)
    check_impls(fc, "bf16 SRVAE train step", family_calls)
    for h in hooks:
        h.remove()
    if not all(torch.isfinite(v) for v in sterms.values()):
        raise AssertionError("bf16 SRVAE train step: non-finite loss terms")
    log(f"bf16 SRVAE super_resolve B=16 from HR input: {s_ms:.2f} ms (first call), launches "
        + " ".join(f"{k[0]}={v}" for k, v in s_counts.items()) + f"; chained {s_c_ms:.2f} ms, "
        + "launches " + " ".join(f"{k[0]}={v}" for k, v in s_chain_counts.items())
        + f", max|diff| vs unchained {s_chain_err:.3e}; train step B={n} launches "
        + " ".join(f"{k[0]} {k[1]}={v}" for k, v in st_counts.items()))
    bf["families"] = {"vae_train_launches": {" ".join(k): v for k, v in vcounts.items()},
                      "vae_draws_ms": vae_ms, "vae_draws_max_abs_err": vae_err,
                      "vae_chained_draws_ms": vae_c_ms, "vae_chained_max_abs_err": vae_chain_err,
                      "vae_chained_launches": {" ".join(k): v for k, v in vchain_counts.items()},
                      "srvae_super_resolve_ms": s_ms, "srvae_chained_super_resolve_ms": s_c_ms,
                      "srvae_chained_max_abs_err": s_chain_err,
                      "srvae_chained_launches": {" ".join(k): v
                                                 for k, v in s_chain_counts.items()},
                      "srvae_train_launches": {" ".join(k): v for k, v in st_counts.items()}}
    del trainer, srvae, srs

    # B6. every distinct bfloat16 shape of the serving run and the steps, timed
    def key_of(call):
        name, role, shape, o, relu, site, _ = call
        return name, role, shape, o, relu, site if role == "dx" else None

    per_key = {}
    paths = (("serving", serve_calls), ("train_step", train_calls), ("val_step", val_calls))
    for i, call in enumerate(sorted({key_of(c) for _, cs in paths for c in cs}, key=str)):
        name, role, shape, o, relu, site = call
        per_key[call] = row = check_shape_bf16(fc, name, shape, o, relu, seed=900 + i,
                                               timing=True, site=site)
        bf["shapes"].append(row)
        turns = ("" if row["wg_ms"] is None else
                 f" [wg {row['wg_ms']:.4f} ms, tc {row['tc_ms']:.4f} ms in turns "
                 + "/".join(f"{t:.4f}" for t in row["turns_ms"]) + "]")
        log(f"bf16 shape {name} {role} x{shape} O={o}: kernel ({row['impl']}) {row['ms']:.4f} ms"
            f"{turns}, plain {row['plain_ms']:.4f} ms, cuDNN bf16 {row['library_ms']:.4f} ms, "
            f"float32 kernel {row['f32_kernel_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), {row['of_bound']:.3f} of the ulp bound, bit-equal "
            f"{row['share_bit_equal']:.4f}")
    slower = [r for r in bf["shapes"] if r["impl"] == "wg" and r["wg_ms"] > r["tc_ms"]]
    log(f"bf16 shapes routed to conv_wg_bf16: {sum(r['impl'] == 'wg' for r in bf['shapes'])} of "
        f"{len(bf['shapes'])}; slower there than conv_tc_bf16 in this run: {len(slower)} "
        + " ".join(f"{r['name']} {r['role']} x{tuple(r['x'])} O={r['o']}" for r in slower))
    fields = ("ms", "tc_ms", "plain_ms", "library_ms", "f32_kernel_ms", "bound_ms", "flops",
              "bytes")
    kernels = []
    for name in fc.TC_KERNELS:
        # #1, #5 and #6 once per kernel that ran ("wg": conv_wg_bf16, "tc":
        # conv_tc_bf16)
        for impl in ("wg", "tc") if name in fc.WG_KERNELS else (None,):
            tot = dict.fromkeys(fields, 0.0)
            by_path = {}
            for path, cs in paths:
                for role in fc.ROLES:
                    mine = [c for c in cs if c[0] == name and c[1] == role
                            and impl in (None, per_key[key_of(c)]["impl"])]
                    if not mine:
                        continue
                    d = dict.fromkeys(("launches",) + fields, 0.0)
                    for c in mine:
                        row = per_key[key_of(c)]
                        d["launches"] += 1
                        for k in fields:
                            d[k] += row[k]
                    by_path[f"{path}_{role}"] = int(d["launches"])
                    for k in fields:
                        tot[k] += d[k]
                    log(f"bf16 {path} {name} {role}{'' if impl is None else ' ' + impl}: "
                        f"launches {int(d['launches'])}, kernel {d['ms']:.3f} ms"
                        + ("" if impl != "wg" else f" (conv_tc_bf16 {d['tc_ms']:.3f} ms)")
                        + f", bound {d['bound_ms']:.3f} ms (989 TFLOP/s, 3.35 TB/s), plain "
                        f"{d['plain_ms']:.3f} ms, cuDNN bf16 {d['library_ms']:.3f} ms, float32 "
                        f"kernel {d['f32_kernel_ms']:.3f} ms")
            rows = [r for r in bf["ragged"] + bf["shapes"]
                    if r["name"] == name and impl in (None, r["impl"])]
            entry = {
                "name": name + BF16_SOURCE_TAG + ("" if impl is None else "_" + impl),
                "route": "cuda", "source": WG_SOURCE if impl == "wg" else SOURCE,
                "replaces": REPLACES[name], "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "max_of_ulp_bound": max(r["of_bound"] for r in rows),
                "min_share_bit_equal": min(r["share_bit_equal"] for r in rows),
                "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": ("operations" if tot["flops"] / PEAK_BF16_FLOPS
                             > tot["bytes"] / PEAK_BYTES else "bytes"),
                "library_ms": tot["library_ms"], "f32_kernel_ms": tot["f32_kernel_ms"],
                "share_of_bound": tot["bound_ms"] / tot["ms"] if tot["ms"] else None,
            }
            if impl == "wg":  # the parent kernel at the same launches, in turns
                entry["tc_ms"] = tot["tc_ms"]
            kernels.append(entry)
    bf["conv4x4s2_by_role"] = conv4_by_role(fc, paths, per_key, key_of)
    if failures:
        raise AssertionError("bf16 phase: " + "; ".join(failures))
    return kernels, (out, uq), {
        "vae_draws_n1000_chained": vchain_counts[(fc.CHAIN, "forward")],
        "srvae_super_resolve_b16_chained": s_chain_counts[(fc.CHAIN, "forward")]}


# ------------------------------------------------------- bfloat16, slice 11
# I1's ragged shapes, then the DownBlock shapes of I4: the bfloat16 int8
# instances bit for bit
BF16_INT8_EXPECTED = {k: v for k, v in INT8_EXPECTED.items() if k.startswith("int8_")
                      or k in ("act_absmax", "act_quant")}
# every 3x3 conv a request runs in float: the W8A8 resolver's float convs (I3)
BF16_INT8_FLOAT_EXPECTED = {k: v for k, v in INT8_EXPECTED.items() if k.startswith("fused_")}
# C1's ragged chains and an 8-layer one (MAX_LAYERS), one to eight layers
RAGGED_CHAIN_BF16 = RAGGED_CHAIN + [((1, 9, 9, 5), (5, 5, 5, 5, 5, 5, 5, 6))]


def bf16_int8_counts(f8, fc):
    """The bfloat16 int8 launches and the bfloat16 #1/#5/#6 forward launches
    since the last reset, and a check that no float32 instance launched."""
    if any(f8.launches.values()) or any(fc.launches.values()):
        raise AssertionError(f"a float32 kernel launched on a bfloat16 path: {f8.launches} "
                             f"{fc.launches}")
    return {**{k: v for k, v in f8.bf16_launches.items()},
            **{k: fc.bf16_launches[k]["forward"] for k in fc.TC_KERNELS},
            fc.CHAIN: fc.bf16_launches[fc.CHAIN]["forward"]}


def bf16_canonical_model(cfg):
    """Phase 4's weights (init_weights(0), BatchNorm statistics from seed 1)
    in a bfloat16 Cond_SRVAE."""
    from simple_vae_rs_tpu_torch import CondSRVAE

    f32_model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
    randomize_bn(f32_model, seed=1)
    model = CondSRVAE(cfg, device="cuda", dtype=torch.bfloat16)
    model.load_state_dict(f32_model.state_dict())
    return model


def bf16_int8_phase(report, f32_out, f32_uq):
    """Phases B7 and B8: the bfloat16 int8 instances at the ragged shapes and
    through ``SuperResolver(bf16 model, int8=True)`` and ``int8_weights``,
    then the DownBlocks' #11 in bfloat16, and every distinct bfloat16 int8
    shape timed. Returns per-kernel totals and launches by path."""
    from simple_vae_rs_tpu_torch import CondSRVAEConfig, SuperResolver
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    rep = report["bf16_int8"] = {"ragged": [], "shapes": []}
    bf = torch.bfloat16
    # B7. I1's ragged shapes in bfloat16
    for i, (name, shape, o, relu, group) in enumerate(RAGGED_INT8):
        row = check_int8_shape(f8, fc, name, shape, o, relu, seed=1600 + i, timing=False,
                               act_group=group, dtype=bf)
        rep["ragged"].append(row)
        log(f"bf16 ragged {name} x{shape} O={o} act_group={group}: bit for bit "
            f"({100 * row['equal_share']:.2f}% equal), quantize pass bytes equal, twice the same")

    # B8. the W8A8 and the weights-only resolver on the bfloat16 canonical model
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    model = bf16_canonical_model(cfg)
    y = np.random.default_rng(2).random((16, cfg.lr_patch_size, cfg.lr_patch_size, 4),
                                        dtype=np.float32)
    modes = {}
    serve_calls = []
    for mode in ("int8", "int8_weights"):
        sr = SuperResolver(model, device="cuda", seed=0, **{mode: True})
        if qz.has_quant(model) or sr.model.dtype != bf or (mode == "int8") != qz.has_quant(sr.model):
            raise AssertionError(f"bf16 {mode}: the resolver's own copy is not what it should be")
        sr.super_resolve(y, seed=0)  # warm: the build, the allocator
        calls = []
        hooks = record_routed_calls(sr.model, calls)
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts()
        out, sr_ms = timed(lambda: sr.super_resolve(y, seed=11))
        after_sr = bf16_int8_counts(f8, fc)
        uq, uq_ms = timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))
        counts = bf16_int8_counts(f8, fc)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for h in hooks:
            h.remove()
        per_uq = {k: counts[k] - after_sr[k] for k in counts}
        if mode == "int8":
            serve_calls = calls
            want = dict(BF16_INT8_EXPECTED, **BF16_INT8_FLOAT_EXPECTED, **{fc.CHAIN: 0})
        else:
            want = {k: 0 for k in f8.bf16_launches}
            want.update({"fused_conv3x3_bn_relu": 24, "fused_conv4x4s2_bn_relu": 5,
                         "fused_convT4x4s2_bn_relu": 3, fc.CHAIN: 0})
        for name, n in want.items():
            if after_sr[name] != n or per_uq[name] != n:
                raise AssertionError(f"bf16 {mode} {name}: {after_sr[name]} launches per "
                                     f"super_resolve, {per_uq[name]} per uncertainty, expected {n}")
        for name in f8.PLAIN:
            recorded = sum(1 for c in calls if c[0] == name)
            if recorded != counts[name]:
                raise AssertionError(f"bf16 {mode} {name}: {counts[name]} launches, {recorded} "
                                     f"calls")
        served_ok(f"bf16 {mode} super_resolve", out, (16, 64, 64, 4))
        if out.dtype != torch.float32 or any(v.dtype != torch.float32 for v in uq.values()):
            raise AssertionError(f"bf16 {mode}: outputs are not float32")
        rep_sr = [timed(lambda: sr.super_resolve(y, seed=11))[1] for _ in range(5)]
        rep_uq = [timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))[1] for _ in range(3)]
        blocks.use_plain_path(sr.model)
        before = {k: dict(v) for k, v in fc.bf16_launches.items()}, dict(f8.bf16_launches)
        plain_sr = sr.super_resolve(y, seed=11)
        plain_uq = sr.uncertainty(y[0], samples=1000, seed=12)
        torch.cuda.synchronize()
        if ({k: dict(v) for k, v in fc.bf16_launches.items()}, dict(f8.bf16_launches)) != before:
            raise AssertionError(f"the bf16 {mode} plain path launched a kernel")
        err = {"super_resolve": float((out - plain_sr).abs().max()),
               "uncertainty.mean": float((uq["mean"] - plain_uq["mean"]).abs().max()),
               "uncertainty.std": float((uq["std"] - plain_uq["std"]).abs().max())}
        psnr = {"super_resolve": psnr_db(out, f32_out),
                "uncertainty.mean": psnr_db(uq["mean"], f32_uq["mean"])}
        for key, e in err.items():
            if not e <= BF16_SERVE_TOL:
                raise AssertionError(f"bf16 {mode} {key}: kernels vs plain path {e} > "
                                     f"{BF16_SERVE_TOL}")
        for key, db in psnr.items():
            if not db > MIN_PSNR_DB:
                raise AssertionError(f"bf16 {mode} {key}: {db:.2f} dB against float32")
        modes[mode] = {"super_resolve_b16_ms": sr_ms, "super_resolve_b16_ms_repeats": rep_sr,
                       "uncertainty_n1000_ms": uq_ms, "uncertainty_n1000_ms_repeats": rep_uq,
                       "peak_memory_gib": peak, "max_abs_err_vs_plain": err,
                       "psnr_db_vs_f32": psnr, "launches_super_resolve_b16": after_sr,
                       "launches": counts}
        log(f"bf16 {mode} serving launches per request: "
            + " ".join(f"{k}={v}" for k, v in after_sr.items() if v)
            + " (no float32 kernel, no chain)")
        log(f"bf16 {mode} super_resolve B=16: median {statistics.median(rep_sr):.2f} ms; "
            f"uncertainty N=1000: median {statistics.median(rep_uq):.2f} ms; peak memory "
            f"{peak:.2f} GiB; kernels vs plain path max|diff| {err}; PSNR against float32 {psnr}")
        del sr, plain_sr, plain_uq
    rep["serving"] = modes
    del model
    torch.cuda.empty_cache()

    # B8. #11 in bfloat16: I4's DownBlocks in a bfloat16 block path
    block_calls = []
    rng = np.random.default_rng(5)
    reset_all_counts()
    worst = 0.0
    for i, (cin, cout, hw) in enumerate(DOWN_BLOCKS):
        block = blocks.DownBlock(cin, cout, device="cuda").eval()
        for mod in block.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(rng)
        randomize_bn(block, seed=20 + i)
        blocks.set_dtype(block, bf)
        qz.attach_quant(block, qz.quantize_params_tree(block, seed=i, prefixes=("",)))
        hooks = record_routed_calls(block, block_calls)
        x = torch.randn((16, hw, hw, cin), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(700 + i)).to(bf)
        with torch.no_grad():
            got = block(x)
            for h in hooks:
                h.remove()
            blocks.use_plain_path(block)
            want = block(x)
        torch.cuda.synchronize()
        if got.dtype != bf or not torch.equal(got, want):
            raise AssertionError(f"bf16 int8 DownBlock {cin}->{cout} at {hw}: not equal to the "
                                 f"plain path")
    block_counts = dict(f8.bf16_launches)
    want_counts = {"int8_conv3x3_bn_relu": 6, "int8_conv4x4s2_bn_relu": 6, "act_absmax": 12,
                   "act_quant": 12, "int8_convT4x4s2_bn_relu": 0}
    if block_counts != want_counts or any(f8.launches.values()):
        raise AssertionError(f"bf16 block path launches {block_counts}, expected {want_counts}")
    log(f"bf16 int8 DownBlocks at the canonical shapes (B=16): int8 4x4/s2 launched "
        f"{block_counts['int8_conv4x4s2_bn_relu']} times, equal to the plain path bit for bit")

    # B8. every distinct bfloat16 int8 shape of the W8A8 run and the block path
    paths = (("serving_int8_bf16", [c for c in serve_calls if c[0] in f8.PLAIN]),
             ("block_path_bf16", [c for c in block_calls if c[0] in f8.PLAIN]))
    fields = ("ms", "plain_ms", "bound_ms", "ops", "bytes", "bf16_kernel_ms", "cudnn_bf16_ms",
              "device_ms", "gemm_ms", "library_ms")
    per_key, totals, by_path = {}, {}, {}
    for path, path_calls in paths:
        for call in path_calls:
            if call not in per_key:
                name, shape, o, relu = call
                row = per_key[call] = check_int8_shape(f8, fc, name, shape, o, relu,
                                                       seed=1800 + len(per_key), timing=True,
                                                       dtype=bf)
                rep["shapes"].append(row)
                am, qt = row["absmax"], row["quant"]
                log(f"bf16 int8 shape {name} x{shape} O={o}: kernel {row['ms']:.4f} ms (device "
                    f"{row['device_ms']} ms), plain {row['plain_ms']:.3f} ms, bf16 conv kernel "
                    f"{row['bf16_kernel_ms']:.4f} ms, cuDNN bf16 {row['cudnn_bf16_ms']:.4f} ms, "
                    f"int8 GEMM {row['gemm_ms']} ms, bound {row['bound_ms']:.4f} ms "
                    f"({row['bound_by']}); absmax pass {am['ms']:.4f} ms (device "
                    f"{am['device_ms']}, bound {am['bound_ms']:.4f}, vector_norm "
                    f"{am['library_ms']:.4f}); quantize pass {qt['ms']:.4f} ms (bound "
                    f"{qt['bound_ms']:.4f}); bit for bit")
            row = per_key[call]
            for kname, src in ((call[0], row), (f8.ABSMAX, row["absmax"]),
                               (f8.QUANT, row["quant"])):
                tot = totals.setdefault(kname, dict.fromkeys(fields + ("max_abs_err",), 0.0))
                for k in fields:
                    if src.get(k) is not None:
                        tot[k] += src[k]
                tot["max_abs_err"] = max(tot["max_abs_err"], src.get("max_abs_err", 0.0))
                by_path.setdefault(kname, {}).setdefault(path, 0)
                by_path[kname][path] += 1
    for name in list(f8.PLAIN) + [f8.QUANT]:
        totals[name]["library_ms"] = None
    for name, tot in totals.items():
        log(f"bf16 int8 paths {name}: launches {by_path[name]}, kernel {tot['ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms"
            + (f", bf16 conv kernel {tot['bf16_kernel_ms']:.3f} ms, cuDNN bf16 "
               f"{tot['cudnn_bf16_ms']:.3f} ms, int8 GEMM {tot['gemm_ms']:.3f} ms"
               if name in f8.PLAIN else ""))
    return totals, by_path


def check_chain_bf16(shape, widths, seed, timing: bool):
    """The chain's bfloat16 instance vs its plain version at one shape: each
    layer (a launch of the chain's first l layers; a layer's sums do not
    depend on the plan) within one bfloat16 ulp at the element plus 1e-4 of
    max|plain| of the plain layer on the kernel's own input
    (``fc.compare_bf16``), the whole chain within the noise rule of the CPU
    parity tests (2x the plain bfloat16 chain's distance from the float32
    chain, plus 1e-4 of max|plain|: a layer one ulp apart carries that on),
    the same bits on a second launch. With ``timing`` also the chain's
    time, the bfloat16 #1 launches it replaces, the plain version, one cuDNN
    bfloat16 call per layer and the bound (989 TFLOP/s, 3.35 TB/s)."""
    from simple_vae_rs_tpu_torch.ops import fused_chain as fch
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    gen = torch.Generator(device="cuda").manual_seed(seed)
    chans = (shape[-1],) + tuple(widths)
    x = torch.randn(shape, generator=gen, device="cuda")
    ks = [torch.randn((3, 3, chans[i], chans[i + 1]), generator=gen, device="cuda")
          / math.sqrt(9 * chans[i]) for i in range(len(widths))]
    bs = [torch.randn((c,), generator=gen, device="cuda") for c in widths]
    xb, kb = x.bfloat16(), [k.bfloat16() for k in ks]
    got = fch.fused_conv3x3_chain(xb, kb, bs)
    want = fch.conv3x3_chain_plain(xb, kb, bs)
    want32 = fch.conv3x3_chain_plain(xb.float(), [k.float() for k in kb], bs)
    torch.cuda.synchronize()
    layers = []
    h = xb
    for l in range(len(widths)):
        layer = got if l == len(widths) - 1 else fch.fused_conv3x3_chain(xb, kb[:l + 1], bs[:l + 1])
        layers.append(fc.compare_bf16(layer, fch.conv3x3_chain_plain(h, kb[l:l + 1], bs[l:l + 1])))
        h = layer
    cmp = fc.compare_bf16(got, want)
    noise = float((want.float() - want32).abs().max())
    bound = 2 * noise + KERNEL_TOL * cmp["max_abs_ref"]
    worst_layer = max(c["of_bound"] for c in layers)
    if (got.dtype != torch.bfloat16 or not torch.isfinite(got.float()).all()
            or not worst_layer <= 1.0 or not cmp["max_abs_err"] <= bound):
        raise AssertionError(f"bf16 chain {shape}->{widths}: layers {layers}, whole {cmp}, "
                             f"noise bound {bound}")
    if not torch.equal(fch.fused_conv3x3_chain(xb, kb, bs), got):
        raise AssertionError(f"bf16 chain {shape}->{widths}: a second launch gave other bits")
    plan = fch.plan_chain(*shape[:3], chans, 2)
    row = {"name": fc.CHAIN + BF16_SOURCE_TAG, "x": list(shape), "widths": list(widths),
           "max_abs_err": cmp["max_abs_err"], "max_abs_ref": cmp["max_abs_ref"],
           "of_noise_bound": cmp["max_abs_err"] / bound if bound else 0.0,
           "share_bit_equal": cmp["share_bit_equal"], "worst_layer_of_ulp_bound": worst_layer,
           "plan": plan_text(shape[0], plan), "shared_memory_bytes": plan.smem_bytes}
    if not timing:
        return row
    ones = [torch.ones(c, device="cuda") for c in widths]

    def per_layer():
        h = xb
        for k, one, b in zip(kb, ones, bs):
            h = fc.fused_conv3x3_bn_relu(h, k, one, b, relu=False)
        return h

    xn = xb.permute(0, 3, 1, 2)
    wts = [k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for k in kb]
    bb = [b.bfloat16() for b in bs]

    def library():
        h = xn
        for wt, b in zip(wts, bb):
            h = F.conv2d(h, wt, b, padding=1)
        return h

    before = {k: dict(v) for k, v in fc.bf16_launches.items()}
    first = cuda_ms(lambda: fch.fused_conv3x3_chain(xb, kb, bs), 1)
    reps = max(3, min(50, int(30.0 / max(first, 1e-3))))
    row["ms"] = cuda_ms(lambda: fch.fused_conv3x3_chain(xb, kb, bs), reps)
    row["per_layer_ms"] = cuda_ms(per_layer, reps)
    row["plain_ms"] = cuda_ms(lambda: fch.conv3x3_chain_plain(xb, kb, bs), reps)
    row["library4_ms"] = cuda_ms(library, reps)
    row["library_ms"] = None  # no single PyTorch call computes the chain
    for name, roles in before.items():  # timing launches are not a path's launches
        fc.bf16_launches[name].update(roles)
    pixels = shape[0] * shape[1] * shape[2]
    flops = 2.0 * 9 * pixels * sum(chans[i] * chans[i + 1] for i in range(len(widths)))
    nbytes = (2.0 * (x.numel() + got.numel() + sum(k.numel() for k in ks))
              + 4.0 * sum(widths))
    bound_row(row, flops, nbytes, PEAK_BF16_FLOPS)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def bf16_chain_phase(report, bf16_out, bf16_uq, family_chains):
    """Phase B9: the chain's bfloat16 instance at C1's ragged shapes and
    every chain of the canonical models, then ``SuperResolver(bf16 model,
    chain=True)`` against the unchained bfloat16 resolver of B2, and
    ``int8=True, chain=True``, which chains nothing. Returns the kernels
    line's entry."""
    from simple_vae_rs_tpu_torch import CondSRVAEConfig, SuperResolver
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_int8 as f8

    rep = report["bf16_chain"] = {"ragged": [], "shapes": []}
    for i, (shape, widths) in enumerate(RAGGED_CHAIN_BF16):
        row = check_chain_bf16(shape, widths, seed=1850 + i, timing=False)
        rep["ragged"].append(row)
        log(f"bf16 ragged chain x{shape}->{widths} ({row['plan']}): worst layer "
            f"{row['worst_layer_of_ulp_bound']:.3f} of its ulp bound, whole chain "
            f"{row['of_noise_bound']:.3f} of the noise bound (max|diff| {row['max_abs_err']:.3e}, "
            f"bit-equal {row['share_bit_equal']:.4f})")
    rows = {}
    for i, (site, shape, widths) in enumerate(CHAIN_SHAPES):
        row = rows[(shape, widths)] = check_chain_bf16(shape, widths, seed=1900 + i, timing=True)
        row["site"] = site
        rep["shapes"].append(row)
        log(f"bf16 chain shape {site} x{shape}->{widths} ({row['plan']}): chain {row['ms']:.4f} ms,"
            f" the {len(widths)} bf16 #1 launches {row['per_layer_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, {len(widths)} cuDNN bf16 calls {row['library4_ms']:.4f} ms,"
            f" bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"{100 * row['share_of_bound']:.1f}% of it), worst layer "
            f"{row['worst_layer_of_ulp_bound']:.3f} of its ulp bound")

    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    model = bf16_canonical_model(cfg)
    y = np.random.default_rng(2).random((16, cfg.lr_patch_size, cfg.lr_patch_size, 4),
                                        dtype=np.float32)
    src = SuperResolver(model, device="cuda", seed=0, chain=True)
    src.super_resolve(y, seed=0)
    with ChainCalls() as chained:
        fc.reset_launches()
        f8.reset_launches()
        out, sr_ms = timed(lambda: src.super_resolve(y, seed=11))
        after_sr = bf16_int8_counts(f8, fc)
        uq, uq_ms = timed(lambda: src.uncertainty(y[0], samples=1000, seed=12))
        counts = bf16_int8_counts(f8, fc)
    per_request = {"fused_conv3x3_bn_relu": 16, fc.CHAIN: 2, "fused_conv4x4s2_bn_relu": 5,
                   "fused_convT4x4s2_bn_relu": 3}  # C2's float32 counts
    for name, n in per_request.items():
        if after_sr[name] != n or counts[name] - after_sr[name] != n:
            raise AssertionError(f"bf16 chained serving {name}: {after_sr[name]} and "
                                 f"{counts[name] - after_sr[name]} launches, expected {n}")
    u = cfg.u_channels
    ey = (64, 128, 128, 2 * u)
    if chained.calls != [((16, 8, 8, 64), ey), ((16, 64, 64, 64), TAIL), ((1, 8, 8, 64), ey),
                         ((1000, 64, 64, 64), TAIL)]:
        raise AssertionError(f"bf16 chained serving routed the chains {chained.calls}")
    served_ok("bf16 chained super_resolve", out, (16, 64, 64, 4))
    err = {"super_resolve": float((out - bf16_out).abs().max()),
           "uncertainty.mean": float((uq["mean"] - bf16_uq["mean"]).abs().max()),
           "uncertainty.std": float((uq["std"] - bf16_uq["std"]).abs().max())}
    for key, e in err.items():
        if not e <= BF16_SERVE_TOL:
            raise AssertionError(f"bf16 chained {key} vs the unchained bf16 resolver: {e}")
    rep_sr = [timed(lambda: src.super_resolve(y, seed=11))[1] for _ in range(5)]
    rep_uq = [timed(lambda: src.uncertainty(y[0], samples=1000, seed=12))[1] for _ in range(3)]
    log("bf16 chained serving launches per request: "
        + " ".join(f"{k}={v}" for k, v in after_sr.items() if v)
        + f"; super_resolve B=16 median {statistics.median(rep_sr):.2f} ms, uncertainty N=1000 "
        f"median {statistics.median(rep_uq):.2f} ms; max|diff| vs the unchained bf16 resolver {err}")
    del src
    # int8 with the chain: a model with int8 weights chains no tail
    src8 = SuperResolver(model, device="cuda", seed=0, int8=True, chain=True)
    with ChainCalls() as chained8:
        fc.reset_launches()
        f8.reset_launches()
        src8.super_resolve(y, seed=11)
        c8 = bf16_int8_counts(f8, fc)
    if chained8.calls or chained8.plain_calls or c8[fc.CHAIN] or any(
            c8[k] != v for k, v in BF16_INT8_EXPECTED.items()):
        raise AssertionError(f"bf16 W8A8 chained serving launched {c8}, chains {chained8.calls}")
    log(f"bf16 W8A8 with chain=True: no chain launched; launches "
        + " ".join(f"{k}={v}" for k, v in c8.items() if v))
    rep["serving"] = {"super_resolve_b16_ms_repeats": rep_sr, "uncertainty_n1000_ms_repeats": rep_uq,
                      "super_resolve_b16_ms": sr_ms, "uncertainty_n1000_ms": uq_ms,
                      "launches_super_resolve_b16": after_sr, "launches": counts,
                      "max_abs_err_vs_unchained_bf16": err, "w8a8_chained_launches": c8}
    del src8, model
    torch.cuda.empty_cache()

    by_path = {"serving_chained_bf16": chained.calls}
    tot = dict.fromkeys(("ms", "per_layer_ms", "plain_ms", "library4_ms", "bound_ms", "ops",
                         "bytes"), 0.0)
    for shape, widths in chained.calls:
        row = rows[(shape, widths)]
        for key in tot:
            tot[key] += row[key]
    every = rep["ragged"] + rep["shapes"]
    return {
        "name": fc.CHAIN + BF16_SOURCE_TAG, "route": "cuda", "source": CHAIN_SOURCE,
        "replaces": "simple_vae_rs_tpu/ops/pallas_conv.py:581",
        "also_replaces": "simple_vae_rs_tpu/ops/pallas_conv.py:502",
        "launches": len(chained.calls),
        "launches_by_path": {**{k: len(v) for k, v in by_path.items()}, **family_chains},
        "max_abs_err": max(r["max_abs_err"] for r in every),
        "max_of_noise_bound": max(r["of_noise_bound"] for r in every),
        "max_layer_of_ulp_bound": max(r["worst_layer_of_ulp_bound"] for r in every),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops"] / PEAK_BF16_FLOPS > tot["bytes"] / PEAK_BYTES
                     else "bytes"),
        "library_ms": None,  # no single PyTorch call computes the chain
        "per_layer_kernels_ms": tot["per_layer_ms"], "library_calls_per_layer_ms": tot["library4_ms"],
        "share_of_bound": tot["bound_ms"] / tot["ms"],
    }


# ------------------------------------------------------- serving a whole raster
# H2's scene: an 8x8 mosaic of G1's LR tiles (128 px, int16 digital numbers of
# SyntheticHFDataset scenes), 1024x1024x4 LR, a 10.24 km square of Sentinel-2
# 10 m bands; H1 serves crops of it. The canonical window is 32 LR px with the
# default overlap 4 (stride 28): 1369 windows of the scene (86 dispatches of
# 16), 361 of H_TILE (23), 81 of H_UQ (6, of 32 draws each)
H_SCENE, H_TILE, H_UQ, H_UQ_SAMPLES, H_BATCH = 1024, 512, 256, 32, 16
H_INTERRUPT = 3  # H2: the resumed sweep fails after writing this many bands
H_REQUESTS = 8  # H3: concurrent B=1 requests to the batching server
# what the JAX server replies (tests/test_torch_port_server.py holds the port's
# server to it on the CPU)
H_HEALTH_KEYS = {"status", "model", "patch_size", "channels", "int8", "int8_weights", "mesh",
                 "moments", "seed", "wire_u16"}
H_REPLY_KEYS = {"/v1/super_resolve": {"sr"}, "/v1/super_resolve_moments": {"s1", "s2"},
                "/v1/super_resolve_tile": {"sr"},
                "/v1/uncertainty": {"mean", "std", "variance"},
                "/v1/uncertainty_tile": {"mean", "std", "variance"}}


def h_counts():
    """Every launch counter since the last reset, flat and nonzero, under the
    kernels line's names: float32 kernels, bfloat16 #1/#5/#6 by the kernel
    that ran (``<name>_bf16_wg`` / ``_tc``), the bfloat16 chain, the int8
    kernels and passes (bfloat16 ``<name>_bf16``), the quantizer."""
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc
    from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    out = {**fc.launches, **f8.launches, **qz.launches,
           **{k + BF16_SOURCE_TAG: v for k, v in f8.bf16_launches.items()},
           fc.CHAIN + BF16_SOURCE_TAG: fc.bf16_launches[fc.CHAIN]["forward"]}
    for name, roles in fc.bf16_impl_launches.items():
        for impls in roles.values():
            for impl, n in impls.items():
                key = f"{name}{BF16_SOURCE_TAG}_{impl}"
                out[key] = out.get(key, 0) + n
    return {k: v for k, v in out.items() if v}


def h_path(fn):
    """``fn`` run with every counter set to 0 just before and read just after
    (synchronized): its result, its ms and the counts."""
    reset_all_counts()
    out, ms = timed(fn)
    return out, ms, h_counts()


def h_times(counts, n):
    return {k: v * n for k, v in counts.items()}


def h_expect(what, got, want, paths):
    """Launches of one path equal ``want``; every conv of the path launched
    its kernel; the counts kept for the kernels line."""
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    convs = ("fused_conv3x3_bn_relu", "fused_conv4x4s2_bn_relu", "fused_convT4x4s2_bn_relu")
    if not all(any(k.startswith(c) for k in got) for c in convs):
        raise AssertionError(f"{what}: a conv kernel was launched no time: {got}")
    paths[what] = got


def h_windows(h, w, p, batch, overlap=4):
    """(windows, dispatches) of a raster's window grid in memory, and the
    dispatches of its streamed sweep (one window row at a time)."""
    from simple_vae_rs_tpu_torch.tiling import grid_starts

    rows, cols = (len(grid_starts(n, p, p - overlap)) for n in (h, w))
    return rows * cols, -(-rows * cols // batch), rows * -(-cols // batch)


def h_traced(fn, path):
    """``fn`` under ``torch.profiler``: its ms on the host and the card's busy
    ms in it (kernels, copies, sets)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("h_request"):
            fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    ((t0, dur),) = [(e["ts"], e["dur"]) for e in events
                    if e.get("name") == "h_request" and e.get("cat") == "user_annotation"]
    return dur / 1e3, gpu_busy_us(events, t0, t0 + dur) / 1e3


def h_psnr(a, b) -> float:
    return float(10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12)))


def h1_tiles(card, scene, dtype, paths, f32_ref, tmp):
    """H1 in one dtype: per-dispatch launches, the tile and UQ requests
    (counted, timed, traced), a seeded repeat, a resumed row sweep, and the
    plain path on the same seeds. Returns the numbers, the per-dispatch
    counts and the outputs."""
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, SuperResolver, tiling, warmup
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks

    label = "bf16" if dtype == torch.bfloat16 else "f32"
    cfg = CondSRVAEConfig(cr=G_CR, patch_size=G_PS)
    if dtype == torch.bfloat16:
        model = bf16_canonical_model(cfg)
    else:
        model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
        randomize_bn(model, seed=1)
    sr = SuperResolver(model, device="cuda", seed=0)
    warmup(sr)  # the window batch and the 32-draw moments request too
    p = sr.window
    tile = scene[:H_TILE, :H_TILE].astype(np.float32)
    uq = scene[:H_UQ, :H_UQ].astype(np.float32)
    n_tile, d_tile, _ = h_windows(H_TILE, H_TILE, p, H_BATCH)
    n_uq, d_uq, _ = h_windows(H_UQ, H_UQ, p, H_BATCH)
    wins = np.random.default_rng(3).random((H_BATCH, p, p, 4), dtype=np.float32)
    _, disp_ms, per_sr = h_path(lambda: sr.super_resolve(wins, normalize=False, seed=1))
    _, mom_ms, per_mom = h_path(lambda: sr.super_resolve_moments(wins, H_UQ_SAMPLES, seed=1))
    if per_mom != h_times(per_sr, H_UQ_SAMPLES):
        raise AssertionError(f"H1 {label}: a moments dispatch launched {per_mom}, not "
                             f"{H_UQ_SAMPLES} x {per_sr}")
    stitch_ms = []
    real_stitch = tiling.stitch

    def counted_stitch(*a, **k):
        t0 = time.perf_counter()
        out = real_stitch(*a, **k)
        stitch_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    tiling.stitch = counted_stitch
    try:
        out, tile_ms, got = h_path(lambda: sr.super_resolve_tile(tile, seed=21))
        h_expect(f"H1 {label} super_resolve_tile", got, h_times(per_sr, d_tile), paths)
        tile_stitch = sum(stitch_ms)
        maps, uq_ms, got = h_path(lambda: sr.uncertainty_tile(uq, samples=H_UQ_SAMPLES, seed=22))
        h_expect(f"H1 {label} uncertainty_tile", got, h_times(per_mom, d_uq), paths)
        uq_stitch = sum(stitch_ms) - tile_stitch
        rep_tile = [timed(lambda: sr.super_resolve_tile(tile, seed=21))[1] for _ in range(3)]
        rep_uq = [timed(lambda: sr.uncertainty_tile(uq, samples=H_UQ_SAMPLES, seed=22))[1]
                  for _ in range(3)]
    finally:
        tiling.stitch = real_stitch
    trace = os.path.join(tmp, "h1_trace.json")
    tile_host, tile_busy = h_traced(lambda: sr.super_resolve_tile(tile, seed=21), trace)
    uq_host, uq_busy = h_traced(lambda: sr.uncertainty_tile(uq, samples=H_UQ_SAMPLES, seed=22),
                                trace)
    if out.shape != (2 * H_TILE, 2 * H_TILE, 4) or not np.isfinite(out).all() \
            or out.min() < 0 or out.max() > 1:
        raise AssertionError(f"H1 {label}: tile output {out.shape} wrong or outside [0, 1]")
    if not np.array_equal(out, sr.super_resolve_tile(tile, seed=21)):
        raise AssertionError(f"H1 {label}: a seeded repeat differs")
    for k in ("mean", "std", "variance"):
        if maps[k].shape != (2 * H_UQ, 2 * H_UQ, 4) or not np.isfinite(maps[k]).all():
            raise AssertionError(f"H1 {label}: uncertainty_tile[{k}] is wrong")
    if not float(maps["std"].max()) > 0:
        raise AssertionError(f"H1 {label}: the draws do not differ")
    # a row sweep resumed at a middle band: the uninterrupted sweep's rows
    mn, mx = tile.min(axis=(0, 1)), tile.max(axis=(0, 1))
    norm = (tile - mn) / (mx - mn + 1e-5)
    sweep = list(sr.iter_tile_rows(lambda a, b: norm[a:b], H_TILE, H_TILE, seed=23))
    mid = len(sweep) // 2
    resumed = list(sr.iter_tile_rows(lambda a, b: norm[a:b], H_TILE, H_TILE, seed=23,
                                     start_band=mid))
    if [r for r, _ in resumed] != [r for r, _ in sweep[mid:]] or not all(
            np.array_equal(a, b) for (_, a), (_, b) in zip(resumed, sweep[mid:])):
        raise AssertionError(f"H1 {label}: the sweep resumed at band {mid} differs")
    # the plain path on the same seeds
    blocks.use_plain_path(sr.model)
    reset_all_counts()
    plain, plain_ms = timed(lambda: sr.super_resolve_tile(tile, seed=21))
    plain_maps = sr.uncertainty_tile(uq, samples=H_UQ_SAMPLES, seed=22)
    if h_counts():
        raise AssertionError(f"H1 {label}: the plain path launched {h_counts()}")
    blocks.use_plain_path(sr.model, False)
    err = {"tile": float(np.abs(out - plain).max()),
           **{f"uq.{k}": float(np.abs(maps[k] - plain_maps[k]).max())
              for k in ("mean", "variance")}}
    tol = BF16_SERVE_TOL if label == "bf16" else SERVE_TOL
    for k, e in err.items():
        if not e <= tol:
            raise AssertionError(f"H1 {label} {k}: kernels vs plain path {e} > {tol}")
    db = None
    if f32_ref is not None:
        db = h_psnr(out, f32_ref)
        if not db >= MIN_PSNR_BF16_DB:
            raise AssertionError(f"H1 bf16 tile: PSNR {db:.2f} dB against f32")
    row = {"dtype": label, "per_dispatch": per_sr, "dispatch_ms": disp_ms,
           "moments_dispatch_ms": mom_ms, "tile_windows": n_tile, "tile_dispatches": d_tile,
           "tile_ms": tile_ms, "tile_ms_repeats": rep_tile,
           "tile_windows_per_s": n_tile / statistics.median(rep_tile) * 1e3,
           "tile_stitch_ms": tile_stitch, "tile_traced_ms": tile_host,
           "tile_device_ms": tile_busy, "uq_windows": n_uq, "uq_dispatches": d_uq,
           "uq_ms": uq_ms, "uq_ms_repeats": rep_uq,
           "uq_windows_per_s": n_uq / statistics.median(rep_uq) * 1e3,
           "uq_stitch_ms": uq_stitch, "uq_traced_ms": uq_host, "uq_device_ms": uq_busy,
           "plain_tile_ms": plain_ms, "max_abs_err_vs_plain": err, "psnr_vs_f32_db": db,
           "sweep_bands": len(sweep), "resumed_at": mid}
    log(f"H1 {label} super_resolve_tile {H_TILE}x{H_TILE}x4 ({n_tile} windows, {d_tile} "
        f"dispatches of {H_BATCH}): {tile_ms:.1f} ms first, median "
        f"{statistics.median(rep_tile):.1f} ms = {row['tile_windows_per_s']:.0f} windows/s; "
        f"stitch on the host {tile_stitch:.1f} ms; traced {tile_host:.1f} ms with the card "
        f"busy {tile_busy:.1f} ms; plain path {plain_ms:.1f} ms; launches = {d_tile} x "
        + " ".join(f"{k}={v}" for k, v in per_sr.items()) + f"; card {card}")
    log(f"H1 {label} uncertainty_tile {H_UQ}x{H_UQ}x4 samples={H_UQ_SAMPLES} ({n_uq} windows, "
        f"{d_uq} dispatches of {H_UQ_SAMPLES} draws): {uq_ms:.1f} ms first, median "
        f"{statistics.median(rep_uq):.1f} ms = {row['uq_windows_per_s']:.1f} windows/s; stitch "
        f"{uq_stitch:.1f} ms; traced {uq_host:.1f} ms, card busy {uq_busy:.1f} ms; one moments "
        f"dispatch {mom_ms:.1f} ms against one draw {disp_ms:.2f} ms; card {card}")
    log(f"H1 {label} checks: kernels vs plain path max|diff| {err} (tolerance {tol})"
        + ("" if db is None else f", PSNR against f32 {db:.2f} dB")
        + f"; seeded repeat bit-equal; sweep of {len(sweep)} bands resumed at band {mid} "
        f"bit-equal")
    del sr, model
    torch.cuda.empty_cache()
    return row, per_sr, per_mom, out


def h2_raster(card, tmp, src, ck, per_sr, per_mom, paths):
    """H2: ``python -m simple_vae_rs_tpu_torch.raster``'s ``main`` in process on
    the scene with phase G's checkpoint: in memory, ``--stream``, a resumed
    ``--stream --resume``, ``--uncertainty``, ``--int8``, ``--int8_weights``.
    Returns the numbers and the in-memory and streamed products' paths."""
    from simple_vae_rs_tpu_torch import SuperResolver, raster
    from simple_vae_rs_tpu_torch.data import tiffio

    p = G_PS // 2
    n_win, d_mem, d_stream = h_windows(H_SCENE, H_SCENE, p, H_BATCH)
    rows = {}

    def run(label, argv, want):
        out_path = os.path.join(tmp, f"h2_{label}.tif")  # the journal's output for "resume"
        _, ms, got = h_path(lambda: raster.main([src, out_path, "--model_ckpt", ck, *argv]))
        h_expect(f"H2 raster {label}", got, want, paths)
        with tiffio.TiffReader(out_path) as r, tiffio.TiffReader(src) as s:
            if (r.height, r.width, r.samples_per_pixel, r.dtype, r.layout) != (
                    2 * s.height, 2 * s.width, s.samples_per_pixel, s.dtype, s.layout):
                raise AssertionError(f"H2 {label}: output {r.shape} {r.dtype} {r.layout} "
                                     f"does not mirror {s.shape} {s.dtype} {s.layout}")
        rows[label] = {"s": ms / 1e3, "launches": got}
        log(f"H2 raster {label}: {ms / 1e3:.2f} s, launches "
            + " ".join(f"{k}={v}" for k, v in got.items()) + f"; card {card}")
        return out_path

    seed = ["--request_seed", "7"]
    mem = run("memory", seed, h_times(per_sr, d_mem))
    # where the in-memory run's seconds go: the model's load and the tile
    # request, each on its own; the rest is reading, normalizing and writing
    lr, read_ms = timed(lambda: tiffio.read_tiff(src).astype(np.float32))
    res, load_ms = timed(lambda: SuperResolver.from_checkpoint(ck, device="cuda"))
    mn = lr.min(axis=(0, 1), keepdims=True)
    den = lr.max(axis=(0, 1), keepdims=True) - mn + 1e-5
    product, tile_ms = timed(lambda: res.super_resolve_tile(lr, seed=7))
    want = np.clip(np.rint(product * den + mn), -32768, 32767).astype(np.int16)
    rows["memory"].update({"read_ms": read_ms, "load_ms": load_ms, "tile_ms": tile_ms})
    if not np.array_equal(tiffio.read_tiff(mem), want):
        raise AssertionError("H2 in memory: the product differs from super_resolve_tile's")
    stream = run("stream", ["--stream", *seed], h_times(per_sr, d_stream))
    # --resume: the sweep fails after H_INTERRUPT bands, then resumes from its
    # journal; the recomputed windows start at the earliest row reaching in
    from simple_vae_rs_tpu_torch.tiling import grid_starts

    starts = grid_starts(H_SCENE, p, p - 4)
    first = H_INTERRUPT
    while first > 0 and starts[first - 1] + p > starts[H_INTERRUPT]:
        first -= 1
    resumed = os.path.join(tmp, "h2_resume.tif")
    real, calls = tiffio.TiffStripWriter.write_rows, {"n": 0}

    def bomb(self, block):
        calls["n"] += 1
        if calls["n"] > H_INTERRUPT:
            raise RuntimeError("interrupted")
        return real(self, block)

    tiffio.TiffStripWriter.write_rows = bomb
    try:
        t0 = time.perf_counter()
        try:
            raster.main([src, resumed, "--model_ckpt", ck, "--stream", "--resume", *seed])
            raise AssertionError("H2 resume: the sweep was not interrupted")
        except RuntimeError as e:
            if str(e) != "interrupted":
                raise
        cut_s = time.perf_counter() - t0
    finally:
        tiffio.TiffStripWriter.write_rows = real
    with open(resumed + ".resume.json") as fh:
        if json.load(fh)["next_band"] != H_INTERRUPT:
            raise AssertionError("H2 resume: the journal is not at the interrupted band")
    cols = -(-len(starts) // H_BATCH)
    run("resume", ["--stream", "--resume", *seed], h_times(per_sr, (len(starts) - first) * cols))
    with open(resumed, "rb") as a, open(stream, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("H2 --stream --resume: not the uninterrupted sweep's bytes")
    rows["resume"]["interrupted_s"] = cut_s
    unc = run("uncertainty", ["--uncertainty", "--samples", str(H_UQ_SAMPLES), *seed],
              h_times(per_mom, d_mem))
    std = tiffio.read_tiff(unc[:-4] + "_std.tif")
    if std.dtype != np.float32 or std.shape != (2 * H_SCENE, 2 * H_SCENE, 4) \
            or not np.isfinite(std).all() or not std.max() > 0:
        raise AssertionError(f"H2 --uncertainty: std {std.shape} {std.dtype} is wrong")
    for mode in ("int8", "int8_weights"):
        probe, _, build = h_path(lambda: SuperResolver.from_checkpoint(ck, device="cuda",
                                                                       **{mode: True}))
        wins = np.random.default_rng(4).random((H_BATCH, p, p, 4), dtype=np.float32)
        _, _, per = h_path(lambda: probe.super_resolve(wins, normalize=False, seed=1))
        del probe
        want = {k: build.get(k, 0) + d_mem * per.get(k, 0) for k in {*build, *per}}
        run(mode, [f"--{mode}", *seed], want)
        if mode == "int8":
            for k in ("quantize_stochastic", "int8_conv3x3_bn_relu", "int8_convT4x4s2_bn_relu",
                      "act_absmax", "act_quant"):
                if not rows[mode]["launches"].get(k):
                    raise AssertionError(f"H2 --int8 launched {k} no time")
    del res
    torch.cuda.empty_cache()
    log(f"H2 scene {H_SCENE}x{H_SCENE}x4 int16 LZW ({n_win} windows, {d_mem} dispatches in "
        f"memory, {d_stream} streamed): " + ", ".join(f"{k} {v['s']:.2f} s"
                                                      for k, v in rows.items())
        + f" (the interrupted sweep {cut_s:.2f} s; of the in-memory run, alone: read "
        f"{read_ms:.0f} ms, model load {load_ms:.0f} ms, super_resolve_tile {tile_ms:.0f} ms); "
        f"outputs int16 "
        f"{2 * H_SCENE}x{2 * H_SCENE}x4 in the input's layout, in memory = "
        f"super_resolve_tile's bits, resumed = uninterrupted bytes; card {card}")
    return rows, mem, stream


def h3_server(card, tmp, src, ck, scene, per_sr, mem, stream, paths):
    """H3: the port's server on a thread, driven by the port's client."""
    import threading

    from simple_vae_rs_tpu_torch import SuperResolver, raster, warmup
    from simple_vae_rs_tpu_torch.client import Client
    from simple_vae_rs_tpu_torch.server import make_server

    res = SuperResolver.from_checkpoint(ck, device="cuda")
    warmup(res)
    out = {}
    srv = make_server(res, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        c = Client(url, timeout=600)
        health = c.health()
        if set(health) != H_HEALTH_KEYS or health["status"] != "ok" \
                or health["patch_size"] != G_PS:
            raise AssertionError(f"H3 /healthz {health}")
        y = np.random.default_rng(5).random((H_BATCH, G_PS // 2, G_PS // 2, 4),
                                            dtype=np.float32)
        uq = scene[:H_UQ, :H_UQ].astype(np.float32)
        for path, (arr, opts) in {
                "/v1/super_resolve": (y, {"seed": 1}),
                "/v1/super_resolve_moments": (y, {"samples": 2, "seed": 1}),
                "/v1/super_resolve_tile": (uq, {"seed": 1}),
                "/v1/uncertainty": (y[0], {"samples": 4, "seed": 1}),
                "/v1/uncertainty_tile": (uq, {"samples": 2, "seed": 1})}.items():
            reply = c._post_array(path, arr, **opts)
            if set(reply) != H_REPLY_KEYS[path] or any(v.dtype != np.float32
                                                       for v in reply.values()):
                raise AssertionError(f"H3 {path}: reply keys {sorted(reply)}")
        local = res.super_resolve(y, seed=5).cpu().numpy()
        if not np.array_equal(c.super_resolve(y, seed=5), local):
            raise AssertionError("H3: the f32 npy wire's reply differs from the in-process bits")
        u16 = Client(url, timeout=600, wire="u16").super_resolve(y, seed=5)
        # wire.py's bound, half a step of the channel's range, plus float32's
        # rounding of lo + q * step (the codec tests' slack)
        step = (local.max(axis=(0, 1, 2)) - local.min(axis=(0, 1, 2))) / 65535
        u16_err = float(np.abs(u16 - local).max())
        if not (np.abs(u16 - local) <= 0.5 * step + 1e-6 * np.abs(local) + 1e-9).all():
            raise AssertionError(f"H3: the u16 wire's reply is {u16_err} off, past half a step")
        rr = c.resolver()
        try:
            if not np.array_equal(rr.super_resolve_tile(uq, seed=6),
                                  c.super_resolve_tile(uq, seed=6)):
                raise AssertionError("H3: RemoteResolver's stitch differs from the server's")
        finally:
            rr.close()
        for label, extra, local_out in (("memory", [], mem), ("stream", ["--stream"], stream)):
            url_out = os.path.join(tmp, f"h3_url_{label}.tif")
            t0 = time.perf_counter()
            raster.main([src, url_out, "--url", url, "--request_seed", "7", *extra])
            out[f"raster_url_{label}_s"] = time.perf_counter() - t0
            with open(url_out, "rb") as a, open(local_out, "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"H3 raster --url ({label}) differs from the local "
                                         "product")
        # round trips against the same work in process (its copy to the host included)
        http = [timed(lambda: c.super_resolve(y, seed=5))[1] for _ in range(5)]
        proc = [timed(lambda: res.super_resolve(y, seed=5).cpu())[1] for _ in range(5)]
        http_m = [timed(lambda: c.super_resolve_moments(y, H_UQ_SAMPLES, seed=5))[1]
                  for _ in range(3)]
        proc_m = [timed(lambda: [t.cpu() for t in res.super_resolve_moments(
            y, H_UQ_SAMPLES, seed=5)])[1] for _ in range(3)]
        out.update({"http_b16_ms": http, "inproc_b16_ms": proc, "http_moments_ms": http_m,
                    "inproc_moments_ms": proc_m, "u16_max_abs_err": u16_err})
    finally:
        srv.shutdown()
        srv.server_close()
    # --dynamic_batch_ms 2: concurrent unseeded B=1 requests
    srv = make_server(res, port=0, dynamic_batch_ms=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = Client(f"http://127.0.0.1:{srv.server_address[1]}", timeout=600)
        replies = [None] * H_REQUESTS

        def post(i):
            replies[i] = c.super_resolve(y[i:i + 1])

        reset_all_counts()
        threads = [threading.Thread(target=post, args=(i,)) for i in range(H_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
            if t.is_alive():
                raise AssertionError("H3 batching: a request did not come back")
        torch.cuda.synchronize()
        got = h_counts()
        if any(r is None or r.shape != (1, G_PS, G_PS, 4) for r in replies):
            raise AssertionError("H3 batching: a reply is missing or of the wrong shape")
        disp, rem = divmod(got["fused_conv3x3_bn_relu"], per_sr["fused_conv3x3_bn_relu"])
        batcher = srv.RequestHandlerClass.service.batcher
        if rem or not 1 <= disp <= H_REQUESTS or got != h_times(per_sr, disp) \
                or batcher.dispatches != disp:
            raise AssertionError(f"H3 batching: launches {got} are not whole dispatches "
                                 f"(batcher: {batcher.dispatches})")
        paths["H3 server dynamic batching"] = got
        out.update({"batched_requests": H_REQUESTS, "batched_dispatches": disp,
                    "batched_padded_rows": batcher.padded_rows})
    finally:
        srv.shutdown()
        srv.server_close()
    log(f"H3 server: /healthz and reply keys the JAX server's; B={H_BATCH} seeded over the f32 "
        f"npy wire = in-process bits, over u16 {out['u16_max_abs_err']:.2e} off (within half "
        f"a step); RemoteResolver's stitch = the server's; raster --url = local raster (memory "
        f"{out['raster_url_memory_s']:.2f} s, stream {out['raster_url_stream_s']:.2f} s); "
        f"HTTP round trip B={H_BATCH} median {statistics.median(out['http_b16_ms']):.2f} ms vs "
        f"in process {statistics.median(out['inproc_b16_ms']):.2f} ms; moments "
        f"({H_UQ_SAMPLES} draws) {statistics.median(out['http_moments_ms']):.1f} vs "
        f"{statistics.median(out['inproc_moments_ms']):.1f} ms; --dynamic_batch_ms 2: "
        f"{H_REQUESTS} concurrent B=1 requests in {out['batched_dispatches']} dispatches "
        f"({out['batched_padded_rows']} padded rows); card {card}")
    return out


def raster_phase(report, card, tmp):
    """Phase H: whole rasters on the card, in process (H1), through the
    ``raster`` command (H2) and over HTTP (H3). Returns the launches of each
    path (counted from 0 just before it), by the kernels line's names."""
    from simple_vae_rs_tpu_torch.data import tiffio

    paths = {}
    tree = os.path.join(tmp, "ARM")
    n = H_SCENE // (G_HR // 2)
    tiles = [tiffio.read_tiff(os.path.join(tree, f"S2_{i:04d}_10m.tif")) for i in range(n * n)]
    scene = np.concatenate([np.concatenate(tiles[r * n:(r + 1) * n], axis=1) for r in range(n)])
    src = os.path.join(tmp, "scene_lr.tif")
    tiffio.write_tiff(src, scene, compression="lzw", predictor=True)
    log(f"H scene: {n}x{n} of G1's LR tiles, {scene.shape} {scene.dtype}, LZW + predictor, "
        f"{os.path.getsize(src) / 2**20:.1f} MiB")
    out = {"scene": list(scene.shape)}
    out["h1_f32"], per_sr, per_mom, f32_tile = h1_tiles(card, scene, torch.float32, paths, None,
                                                       tmp)
    out["h1_bf16"], _, _, _ = h1_tiles(card, scene, torch.bfloat16, paths, f32_tile, tmp)
    ck = os.path.join(tmp, "ckpt", "g2")
    out["h2"], mem, stream = h2_raster(card, tmp, src, ck, per_sr, per_mom, paths)
    out["h3"] = h3_server(card, tmp, src, ck, scene, per_sr, mem, stream, paths)
    out["launches"] = paths
    report["raster"] = out
    return paths


# ------------------------------------------- checkpoint tools and the artifact
J_HEALTH_KEYS = {"status", "model", "patch_size", "channels", "artifact", "batch", "platforms",
                 "moments", "seed", "wire_u16"}  # the JAX server's artifact branch
J_TILE = 512  # J2: the artifact's super_resolve_tile, a 512x512x4 crop of H's scene
# J2: bf16 and int8 artifacts against the f32 one, PSNR at peak 1. The H100
# reads 97-114 dB on this script's checkpoints: the outputs sit near 0.5
# with a small spread, so weight rounding moves them by about 1e-5; the
# floor leaves 17 dB below that, and the rounded weights' own live path
# holds the artifacts besides
J_DB_FLOOR = 80.0
# J2: each artifact against the live plain path on its own weights (f32 as
# stored, bf16 and int8 rounded as packed): the same aten ops on the same
# tensors, so the bits agree. The floor is far below SERVE_TOL because the
# outputs respond weakly to the weights (J2 reports how far zeroing the
# decoder's kernels moves them): a wrong dequantization can stay inside
# SERVE_TOL
J_SAME_TOL = 1e-6


def j_all_launches():
    """Every launch counter of the port, flat: float32 and bfloat16 conv
    kernels and chain, the int8 kernels and passes (both dtypes), the
    quantizer, the ELBO rows."""
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    counts = {**h_counts(), **{f"{k} (rows)": v for k, v in fe.launches.items() if v}}
    return {k: v for k, v in counts.items() if v}


def j_no_launch(what, fn):
    """``fn`` with every counter set to 0 just before: it must launch no
    hand-written kernel (the artifact is the plain graph). Its result and ms."""
    from simple_vae_rs_tpu_torch.ops import fused_elbo as fe

    reset_all_counts()
    fe.reset_launches()
    out, ms = timed(fn)
    got = j_all_launches()
    if got:
        raise AssertionError(f"{what}: the artifact launched hand-written kernels: {got}")
    return out, ms


def j1_convert(card, tmp, ck, paths):
    """J1: phase G's checkpoint through ``convert_checkpoint --to_torch``
    (strict and ``--keep_gammas``) and imported back; the re-imported
    checkpoint served on the card."""
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, SuperResolver
    from simple_vae_rs_tpu_torch import convert_checkpoint as conv
    from simple_vae_rs_tpu_torch.train.checkpoint import load_state, read_meta

    flags = ["-cr", str(G_CR), "--patch_size", str(G_PS)]
    secs = {}

    def step(label, argv):
        with open(os.devnull, "w") as null:
            import contextlib

            with contextlib.redirect_stdout(null):
                t0 = time.perf_counter()
                if conv.main(argv) != 0:
                    raise AssertionError(f"J1 convert_checkpoint {label} failed")
                secs[label] = time.perf_counter() - t0

    strict, gammas = os.path.join(tmp, "g2.pth"), os.path.join(tmp, "g2_gammas.pth")
    step("to_torch", [ck, strict, "--to_torch", *flags])
    step("to_torch --keep_gammas", [ck, gammas, "--to_torch", "--keep_gammas", *flags])
    back, back_strict = os.path.join(tmp, "ckpt", "j1_back"), os.path.join(tmp, "ckpt", "j1_strict")
    step("import (gammas)", [gammas, back, *flags])
    step("import (strict)", [strict, back_strict, *flags])
    want = load_state(ck)["model"]
    for path, gammas_back in ((back, True), (back_strict, False)):
        got = load_state(path)["model"]
        for k, v in want.items():
            same = torch.equal(got[k], v) if (gammas_back or not k.startswith("gamma")) \
                else float(got[k]) == 1.0
            if not same:
                raise AssertionError(f"J1 {path}: {k} did not come back")
    if not read_meta(back)["model"]["torch_regroup"]:
        raise AssertionError("J1: the imported checkpoint's meta lost torch_regroup")
    # G's weights under the reference's latent wiring, which the converter
    # records (torch_regroup) and from_checkpoint rebuilds
    ref_model = CondSRVAE(CondSRVAEConfig(cr=G_CR, patch_size=G_PS, torch_regroup=True),
                          device="cuda")
    ref_model.load_state_dict(want)
    ref = SuperResolver(ref_model, device="cuda", seed=0)
    y = np.random.default_rng(31).random((H_BATCH, G_PS // 2, G_PS // 2, 4), dtype=np.float32)
    want_sr = ref.super_resolve(y, seed=11)
    served, ms = timed(lambda: SuperResolver.from_checkpoint(back, device="cuda"))
    secs["from_checkpoint"] = ms / 1e3
    got_sr, _, counts = h_path(lambda: served.super_resolve(y, seed=11))
    if not torch.equal(got_sr, want_sr):
        raise AssertionError("J1: the re-imported checkpoint serves other bits than G's")
    for name in ("fused_conv3x3_bn_relu", "fused_conv4x4s2_bn_relu", "fused_convT4x4s2_bn_relu"):
        if not counts.get(name):
            raise AssertionError(f"J1: the re-imported checkpoint's request launched {name} "
                                 f"no time: {counts}")
    paths["J1 re-imported super_resolve"] = counts
    mb = os.path.getsize(strict) / 1e6
    log(f"J1 convert_checkpoint: G's checkpoint -> .pth (strict, {mb:.1f} MB; --keep_gammas) "
        f"-> imported back, the same weights (strict: gammas 1.0); "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f"; from_checkpoint of the import serves B={H_BATCH} to the bits of G's weights under "
        f"the reference's wiring; launches " + " ".join(f"{k}={v}" for k, v in counts.items())
        + f"; card {card}")
    del served, ref, ref_model
    torch.cuda.empty_cache()
    return {"seconds": secs, "launches": counts}


def j_rounded(live, weights):
    """The live resolver's model with its weights rounded as ``weights``
    packs them, dequantized here in numpy (apart from the graph's own ops):
    the float tensors a compressed artifact stands for."""
    from simple_vae_rs_tpu_torch import export as ex

    tensors = dict([*live.model.named_parameters(), *live.model.named_buffers()])
    with torch.no_grad():
        for name, entry in ex._pack_variables(tensors, weights).items():
            if entry[0] == "bf16":
                value = entry[1].float().numpy()
            elif entry[0] == "int8":
                value = entry[1].numpy().astype(np.float32) * entry[2].numpy()
            else:
                continue
            tensors[name].copy_(torch.from_numpy(value))


def j2_export(card, tmp, ck, scene):
    """J2: G's checkpoint exported in the three weight modes, loaded on the
    card and served; no hand-written kernel launches. Each artifact is held
    to the live plain path on its own weights (f32 as stored, bf16 and int8
    rounded as packed) at J_SAME_TOL. Returns the numbers and the f32
    artifact's resolver."""
    from simple_vae_rs_tpu_torch import SuperResolver, warmup
    from simple_vae_rs_tpu_torch import export as ex
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks

    out = {}
    live = SuperResolver.from_checkpoint(ck, device="cuda", seed=0)
    warmup(live)
    y = np.random.default_rng(32).random((H_BATCH, G_PS // 2, G_PS // 2, 4), dtype=np.float32)
    live_ms = [timed(lambda: live.super_resolve(y, seed=11))[1] for _ in range(5)]
    n_params = None
    arts = {}
    for weights in ex.WEIGHT_MODES:
        path = os.path.join(tmp, f"g2_{weights}.pt2")
        _, export_ms = timed(lambda: ex.export_checkpoint(ck, path, batch=H_BATCH,
                                                          weights=weights))
        esr, load_ms = timed(lambda: ex.load_exported(path, device="cuda"))
        n_params = esr.meta["n_params"]
        sr, first_ms = j_no_launch(f"J2 {weights}", lambda: esr.super_resolve(y, seed=11))
        if sr.device.type != live.device.type or sr.shape != (H_BATCH, G_PS, G_PS, 4) \
                or sr.dtype != torch.float32:
            raise AssertionError(f"J2 {weights}: {sr.device} {tuple(sr.shape)} {sr.dtype}")
        reps = [j_no_launch(f"J2 {weights}", lambda: esr.super_resolve(y, seed=11))[1]
                for _ in range(5)]
        arts[weights] = (esr, sr)
        out[weights] = {"mb": os.path.getsize(path) / 1e6, "export_s": export_ms / 1e3,
                        "load_s": load_ms / 1e3, "first_request_ms": first_ms,
                        "b16_ms": reps}
    blocks.use_plain_path(live.model)
    for weights in ex.WEIGHT_MODES:  # f32 first: the stored weights, then rounded in turn
        if weights != "f32":
            rounded = SuperResolver.from_checkpoint(ck, device="cuda", seed=0)
            j_rounded(rounded, weights)
            blocks.use_plain_path(rounded.model)
        plain = (live if weights == "f32" else rounded).super_resolve(y, seed=11)
        err = float((arts[weights][1] - plain).abs().max())
        if not err <= J_SAME_TOL:
            raise AssertionError(f"J2: the {weights} artifact is {err} off the live plain path "
                                 "on the same weights")
        out[weights]["vs_live_plain"] = err
    # how far the weights move the outputs at all: the decoder's conv
    # kernels zeroed in the live plain path
    zeroed = SuperResolver.from_checkpoint(ck, device="cuda", seed=0)
    blocks.use_plain_path(zeroed.model)
    with torch.no_grad():
        for name, t in zeroed.model.named_parameters():
            if name.startswith("dx_") and t.dim() >= 2:
                t.zero_()
    out["decoder_zeroed_max_diff"] = float(
        (zeroed.super_resolve(y, seed=11) - arts["f32"][1]).abs().max())
    f32 = arts["f32"][1].cpu().numpy()
    out["f32_std"] = float(f32.std())
    for weights in ("bf16", "int8"):
        got = arts[weights][1].cpu().numpy()
        db = h_psnr(got, f32)
        if not db >= J_DB_FLOOR:
            raise AssertionError(f"J2 {weights}: {db:.2f} dB against the f32 artifact, below "
                                 f"{J_DB_FLOOR}")
        out[weights]["db_vs_f32"] = db
        # the rounding's error against the outputs' own spread, not peak 1
        out[weights]["snr_db_vs_spread"] = float(
            10 * np.log10(f32.var() / max(float(np.mean((got - f32) ** 2)), 1e-30)))
    esr = arts["f32"][0]
    tile = scene[:J_TILE, :J_TILE].astype(np.float32)
    a, tile_ms = j_no_launch("J2 tile", lambda: esr.super_resolve_tile(tile, seed=7))
    b, _ = j_no_launch("J2 tile", lambda: esr.super_resolve_tile(tile, seed=7))
    if not np.array_equal(a, b) or a.shape != (2 * J_TILE, 2 * J_TILE, 4):
        raise AssertionError("J2: a seeded tile off the artifact is not bit-equal on repeat")
    out.update({"n_params": n_params, "f32_vs_live_plain": out["f32"]["vs_live_plain"],
                "live_b16_ms": live_ms, "tile_ms": tile_ms})
    log(f"J2 export of G's checkpoint ({n_params} parameters and statistics), B={H_BATCH}: "
        + "; ".join(f"{w} {out[w]['mb']:.1f} MB, export {out[w]['export_s']:.2f} s, load "
                    f"{out[w]['load_s']:.2f} s, request median "
                    f"{statistics.median(out[w]['b16_ms']):.2f} ms (first "
                    f"{out[w]['first_request_ms']:.1f}), max|diff| {out[w]['vs_live_plain']:.2e} "
                    "vs the live plain path on its weights"
                    + (f", {out[w]['db_vs_f32']:.2f} dB vs f32 (floor {J_DB_FLOOR}; "
                       f"{out[w]['snr_db_vs_spread']:.2f} dB against the outputs' spread)"
                       if w != "f32" else "")
                    for w in ex.WEIGHT_MODES)
        + f"; f32 outputs' std {out['f32_std']:.4g}, moved at most "
        f"{out['decoder_zeroed_max_diff']:.3g} by zeroing the decoder's kernels; live resolver "
        "(kernels) "
        f"{statistics.median(live_ms):.2f} ms; no kernel launched; seeded {J_TILE}x{J_TILE}x4 "
        f"tile {tile_ms:.1f} ms, bit-equal on repeat; card {card}")
    del live, rounded, zeroed, arts
    torch.cuda.empty_cache()
    return out, esr


def j3_server(card, tmp, src, esr):
    """J3: the f32 artifact behind ``make_server``: the JAX artifact branch's
    /healthz keys, the in-process bits over HTTP, ``raster --url`` equal to
    the artifact's own product."""
    import threading

    from simple_vae_rs_tpu_torch import raster
    from simple_vae_rs_tpu_torch.client import Client
    from simple_vae_rs_tpu_torch.data import tiffio
    from simple_vae_rs_tpu_torch.server import make_server

    out = {}
    srv = make_server(esr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        c = Client(url, timeout=600)
        health = c.health()
        if set(health) != J_HEALTH_KEYS or not health["artifact"] \
                or health["platforms"] != [esr.device.type] or health["batch"] != H_BATCH:
            raise AssertionError(f"J3 /healthz {health}")
        y = np.random.default_rng(33).random((H_BATCH, G_PS // 2, G_PS // 2, 4),
                                             dtype=np.float32)
        local = esr.super_resolve(y, seed=5).cpu().numpy()
        if not np.array_equal(c.super_resolve(y, seed=5), local):
            raise AssertionError("J3: the artifact server's reply differs from the in-process bits")
        url_out = os.path.join(tmp, "j3_url.tif")
        with open(os.devnull, "w") as null:
            import contextlib

            with contextlib.redirect_stdout(null):
                _, url_ms = j_no_launch("J3 raster --url", lambda: raster.main(
                    [src, url_out, "--url", url, "--request_seed", "7"]))
        lr = tiffio.read_tiff(src)
        f = lr.astype(np.float32)
        mn = f.min(axis=(0, 1), keepdims=True)
        denom = f.max(axis=(0, 1), keepdims=True) - mn + raster._EPS
        sr, local_ms = j_no_launch("J3 local", lambda: esr.super_resolve_tile(f, seed=7))
        if not np.array_equal(tiffio.read_tiff(url_out), raster._cast_like(sr * denom + mn,
                                                                           lr.dtype)):
            raise AssertionError("J3: raster --url against the artifact server differs from the "
                                 "local artifact product")
        out.update({"raster_url_s": url_ms / 1e3, "local_tile_s": local_ms / 1e3})
    finally:
        srv.shutdown()
        srv.server_close()
    log(f"J3 artifact server: /healthz keys the JAX artifact branch's (platforms "
        f"{[esr.device.type]}); "
        f"B={H_BATCH} seeded over HTTP = in-process bits; raster --url on the "
        f"{H_SCENE}x{H_SCENE} scene {out['raster_url_s']:.2f} s = the local artifact product "
        f"({out['local_tile_s']:.2f} s in process); no kernel launched; card {card}")
    return out


def export_phase(report, card, tmp):
    """Phase J: the checkpoint tools (J1) and the artifact (J2, J3) on phase
    G's checkpoint, in G's temporary directory. Returns J1's launches."""
    from simple_vae_rs_tpu_torch.data import tiffio

    t0 = time.perf_counter()
    paths = {}
    ck = os.path.join(tmp, "ckpt", "g2")
    src = os.path.join(tmp, "scene_lr.tif")
    out = {"j1": j1_convert(card, tmp, ck, paths)}
    out["j2"], esr = j2_export(card, tmp, ck, tiffio.read_tiff(src))
    out["j3"] = j3_server(card, tmp, src, esr)
    out["seconds"] = time.perf_counter() - t0
    log(f"J total {out['seconds']:.1f} s; card {card}")
    report["export"] = out
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, SuperResolver, warmup
    from simple_vae_rs_tpu_torch.ops import _build
    from simple_vae_rs_tpu_torch.ops import conv_blocks as blocks
    from simple_vae_rs_tpu_torch.ops import fused_conv as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. versions and card
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"card: {card}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for src, report in _build.ptxas_logs.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"ptxas {src}: {line.strip()}")
    log("ptxas conv_tc: " + tensor_core_ptxas(_build.ptxas_logs["fused_conv.cu"], "conv_tcI", 12)
        + " (dynamic shared memory per tile: ops/fused_conv.tc_smem_bytes)")
    # four tiles in each of the three modes
    log("ptxas conv_tc_bf16: "
        + tensor_core_ptxas(_build.ptxas_logs["fused_conv.cu"], "conv_tc_bf16I", 12)
        + " (dynamic shared memory per tile: ops/fused_conv.tc_smem_bytes(bf16=True))")
    # three channel tiles x two k-group widths in each of the three modes, each
    # at 168 registers: setmaxnreg gives the producer warpgroup 40 and the
    # consumers 232, which another count at entry would not add up to
    wg_regs = tensor_core_ptxas(_build.ptxas_logs[fc.WG_SOURCE], "conv_wg_bf16",
                                len(fc.WG_KERNELS) * len(fc.WG_STAGES))
    if ", 168-168 registers," not in wg_regs:
        raise AssertionError(f"ptxas conv_wg_bf16: {wg_regs}, expected 168 registers each")
    log("ptxas conv_wg_bf16: " + wg_regs
        + " (168 at entry: setmaxnreg gives the producer warpgroup 40, the consumers 232;"
        + " dynamic shared memory per channel tile: csrc/conv_wg.cu wg_smem_bytes)")
    log("ptxas chain: " + tensor_core_ptxas(_build.ptxas_logs["conv_chain.cu"], "chain_kernelIf", 1)
        + " (dynamic shared memory per shape: ops/fused_chain.plan_chain)")
    log("ptxas chain_bf16: "
        + tensor_core_ptxas(_build.ptxas_logs["conv_chain.cu"], "chain_kernelI" + BF16_MANGLED, 1)
        + " (dynamic shared memory per shape: ops/fused_chain.plan_chain(itemsize=2))")
    int8_report = _build.ptxas_logs["int8_conv.cu"]
    # four tiles in each of the three modes, for each output type
    log("ptxas int8_tc: " + tensor_core_ptxas(int8_report, "int8_tcIf", 12)
        + " (dynamic shared memory per tile: ops/fused_int8.tc_smem_bytes); every kernel of "
        + "int8_conv.cu: " + tensor_core_ptxas(int8_report, ""))
    log("ptxas int8_tc_bf16: " + tensor_core_ptxas(int8_report, "int8_tcI" + BF16_MANGLED, 12)
        + "; act_absmax_bf16: "
        + tensor_core_ptxas(int8_report, "act_absmaxI" + BF16_MANGLED, 1)
        + "; act_quant_bf16: " + tensor_core_ptxas(int8_report, "act_quantI" + BF16_MANGLED, 1)
        + "; splitk_reduce bf16: "
        + tensor_core_ptxas(int8_report, "splitk_reduceI" + BF16_MANGLED, 3))
    log("ptxas quantize.cu (col_absmax, stochastic_round): "
        + tensor_core_ptxas(_build.ptxas_logs["quantize.cu"], "", 2))

    # 3. ragged shapes
    report = {"card": card, "torch": torch.__version__, "ragged": [], "shapes": []}
    for i, (name, shape, o, relu) in enumerate(RAGGED):
        row = check_shape(fc, name, shape, o, relu, seed=100 + i, timing=False)
        report["ragged"].append(row)
        log(f"ragged {name} x{shape} O={o} relu={relu}: max|diff| {row['max_abs_err']:.3e}")

    # 4. serving at full width
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    model = CondSRVAE(cfg, device="cuda").init_weights(seed=0)
    randomize_bn(model, seed=1)
    n_params = sum(p.numel() for n, p in model.named_parameters() if not n.startswith("gamma"))
    log(f"model: Cond_SRVAE cr={cfg.cr} ps={cfg.patch_size} params={n_params} (+2 gammas)")
    sr = SuperResolver(model, device="cuda", seed=0)
    warmup(sr)
    y = np.random.default_rng(2).random((16, cfg.lr_patch_size, cfg.lr_patch_size, 4),
                                        dtype=np.float32)

    calls = []  # (kernel, x shape, O) of every conv the serving run launches
    kinds = ((blocks.Conv3x3, "fused_conv3x3_bn_relu", "kernel"),
             (blocks.DownBlock, "fused_conv4x4s2_bn_relu", "downsample"),
             (blocks.UpBlock, "fused_convT4x4s2_bn_relu", "upsample"))
    hooks = []
    for mod in model.modules():
        for cls, name, attr in kinds:
            if type(mod) is cls:
                w = getattr(mod, attr)
                o = (w if attr == "kernel" else w.kernel).shape[-1]
                relu = cls is not blocks.Conv3x3
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, args, name=name, o=o, relu=relu:
                        calls.append((name, tuple(args[0].shape), o, relu))))

    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    sr_out, sr_ms = timed(lambda: sr.super_resolve(y, seed=11))
    sr_counts = conv_counts(fc)
    n_sr_calls = len(calls)
    uq, uq_ms = timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))
    launches = conv_counts(fc)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for h in hooks:
        h.remove()
    log("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items())
        + " | super_resolve(16): " + " ".join(f"{k}={v}" for k, v in sr_counts.items()))
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched by the serving path")
        recorded = sum(1 for c in calls if c[0] == name)
        if recorded != count:
            raise AssertionError(f"{name}: {count} launches but {recorded} calls")

    # served outputs are right: shapes, range, and the plain path on the card
    served_ok("super_resolve", sr_out, (16, 64, 64, 4))
    for key in ("mean", "std", "variance"):
        if tuple(uq[key].shape) != (64, 64, 4) or not torch.isfinite(uq[key]).all():
            raise AssertionError(f"uncertainty[{key}] is wrong")
    if not float(uq["std"].max()) > 0:
        raise AssertionError("uncertainty draws do not differ")
    rep_sr = [timed(lambda: sr.super_resolve(y, seed=11))[1] for _ in range(5)]
    rep_uq = [timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))[1] for _ in range(3)]

    blocks.use_plain_path(model)
    before = dict(fc.launches)
    plain_sr = sr.super_resolve(y, seed=11)
    plain_uq = sr.uncertainty(y[0], samples=1000, seed=12)
    plain_sr_ms = timed(lambda: sr.super_resolve(y, seed=11))[1]  # warm repeats
    plain_uq_ms = timed(lambda: sr.uncertainty(y[0], samples=1000, seed=12))[1]
    if fc.launches != before:
        raise AssertionError("the plain path launched a kernel")
    blocks.use_plain_path(model, False)
    serve_err = {
        "super_resolve": float((sr_out - plain_sr).abs().max()),
        **{f"uncertainty.{k}": float((uq[k] - plain_uq[k]).abs().max())
           for k in ("mean", "std")},
    }
    for key, err in serve_err.items():
        if not err <= SERVE_TOL:
            raise AssertionError(f"{key}: kernels vs plain path max|diff| {err} > {SERVE_TOL}")
    serving = {
        "super_resolve_b16_ms": sr_ms, "super_resolve_b16_ms_repeats": rep_sr,
        "uncertainty_n1000_ms": uq_ms, "uncertainty_n1000_ms_repeats": rep_uq,
        "plain_super_resolve_b16_ms": plain_sr_ms, "plain_uncertainty_n1000_ms": plain_uq_ms,
        "peak_memory_gib": peak_gib, "max_abs_err_vs_plain": serve_err,
        "launches": launches, "launches_super_resolve_b16": sr_counts,
    }
    report["serving"] = serving
    log(f"super_resolve B=16: {sr_ms:.2f} ms (repeats median "
        f"{statistics.median(rep_sr):.2f} ms), plain path {plain_sr_ms:.2f} ms")
    log(f"uncertainty N=1000: {uq_ms:.2f} ms (repeats median "
        f"{statistics.median(rep_uq):.2f} ms), plain path {plain_uq_ms:.2f} ms")
    log(f"peak memory {peak_gib:.2f} GiB; kernels vs plain path max|diff| {serve_err}")

    # 5. every distinct serving shape: check and time
    weight = {}
    for c in calls:
        weight[c] = weight.get(c, 0) + 1
    fields = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_tc_ms", "bound_cuda_core_ms",
              "flops", "bytes")
    totals = {name: dict.fromkeys(fields + ("max_abs_err",), 0.0) for name in launches}
    for i, ((name, shape, o, relu), count) in enumerate(sorted(weight.items())):
        row = check_shape(fc, name, shape, o, relu, seed=200 + i, timing=True)
        row["launches"] = count
        report["shapes"].append(row)
        tot = totals[name]
        for key in fields:
            tot[key] += count * row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
        log(f"shape {name} x{shape} O={o} x{count}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), 3xTF32 bound "
            f"{row['bound_tc_ms']:.4f} ms, CUDA-core bound {row['bound_cuda_core_ms']:.4f} ms, "
            f"max|diff| {row['max_abs_err']:.2e}")
    for row in report["ragged"]:
        tot = totals[row["name"]]
        tot["max_abs_err"] = max(tot["max_abs_err"], row["max_abs_err"])
    for name, tot in totals.items():
        log(f"serving {name}: launches {launches[name]}, kernel {tot['ms']:.3f} ms, bound "
            f"{tot['bound_ms']:.3f} ms, 3xTF32 bound {tot['bound_tc_ms']:.3f} ms, CUDA-core "
            f"bound {tot['bound_cuda_core_ms']:.3f} ms, plain "
            f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms")
    kernel_ms = {(r["name"], tuple(r["x"]), r["o"], r["relu"]): r["ms"] for r in report["shapes"]}
    for req, part, wall in (("super_resolve_b16", calls[:n_sr_calls], rep_sr),
                            ("uncertainty_n1000", calls[n_sr_calls:], rep_uq)):
        busy = sum(kernel_ms[c] for c in part)
        wall_ms = statistics.median(wall)
        serving[f"{req}_kernel_ms"] = busy
        log(f"{req}: conv kernels {busy:.3f} ms of {wall_ms:.3f} ms median wall "
            f"({100 * busy / wall_ms:.1f}%; the rest is other ops, launches and host time)")

    # I1-I6. the int8 serving modes
    int8_totals, int8_launches, f32_in_int8 = int8_phase(report, model, y, sr_out, uq,
                                                         {k: v for k, v in launches.items() if v})
    # C1, C2, C5. the chain kernel and chained serving
    chain_rows, chain_paths = chain_phase(report, model, sr, y, sr_out, uq)
    del sr, model
    torch.cuda.empty_cache()

    # 6-8. training at full width
    train_totals, train_launches = train_phase(report)
    torch.cuda.empty_cache()

    # C3, C4. the chained val step, the VAE and the SRVAE
    family_chains, family_launches = families_phase(report)
    chain_paths.update(family_chains)
    torch.cuda.empty_cache()

    # B1-B6. bfloat16 compute: the bfloat16 instances of #1, #5 and #6
    bf16_kernels, (bf16_out, bf16_uq), bf16_family_chains = bf16_phase(
        report, sr_out, uq, report["training"]["peak_memory_gib"])
    torch.cuda.empty_cache()
    # B7, B8. the bfloat16 int8 instances; B9. the chain's bfloat16 instance
    bf16_int8_totals, bf16_int8_launches = bf16_int8_phase(report, sr_out, uq)
    bf16_chain_entry = bf16_chain_phase(report, bf16_out, bf16_uq, bf16_family_chains)
    del bf16_out, bf16_uq

    kernels = []
    for name in dict.fromkeys(list(totals) + list(train_totals)):
        tot = dict.fromkeys(fields + ("max_abs_err",), 0.0)
        for part in (totals.get(name), train_totals.get(name)):
            if part is None:
                continue
            for key in tot:
                if key == "max_abs_err":
                    tot[key] = max(tot[key], part[key])
                elif part.get(key) is not None:
                    tot[key] += part[key]
        is_row = name in ROW_OPS
        peak = PEAK_F32_FLOPS if is_row else conv_peak(fc, name)
        kernels.append({
            "name": name, "route": "cuda", "source": ROW_SOURCE if is_row else SOURCE,
            "replaces": REPLACES[name],
            "launches": launches.get(name, 0) + sum(train_launches[name].values()),
            "launches_by_path": {"serving": launches.get(name, 0), **train_launches[name],
                                 **f32_in_int8.get(name, {})},
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["flops"] / peak > tot["bytes"] / PEAK_BYTES else "bytes",
            "library_ms": None if is_row else tot["library_ms"],
            **({} if is_row else {**tc_columns(tot),
                                  "bound_cuda_core_ms": tot["bound_cuda_core_ms"]}),
        })
    for name, tot in int8_totals.items():
        peak = PEAK_INT8_OPS if name.startswith("int8_") else PEAK_F32_FLOPS
        kernels.append({
            "name": name, "route": "cuda",
            "source": QUANT_SOURCE if name == "quantize_stochastic" else INT8_SOURCE,
            "replaces": REPLACES[name], "launches": sum(int8_launches[name].values()),
            "launches_by_path": int8_launches[name], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if tot["ops"] / peak > tot["bytes"] / PEAK_BYTES else "bytes",
            "library_ms": tot["library_ms"],
            "f32_kernel_ms": tot["f32_kernel_ms"] or None,
            **({"gemm_ms": tot["gemm_ms"] or None, "share_of_bound": tot["bound_ms"] / tot["ms"]}
               if name in TC_INT8 else {}),
            **({"device_ms": tot["device_ms"] or None,
                "share_of_bound_device": (tot["bound_ms"] / tot["device_ms"]
                                          if tot["device_ms"] else None)}
               if name != "act_quant" else {}),
        })
    tot = dict.fromkeys(("ms", "per_layer_ms", "plain_ms", "library4_ms", "bound_ms",
                         "bound_tc_ms", "bound_cuda_core_ms", "ops", "bytes"), 0.0)
    for path_calls in chain_paths.values():
        for shape, widths in path_calls:
            row = chain_rows.row(shape, widths)
            for key in tot:
                tot[key] += row[key]
    chain_err = max(r["max_abs_err"] for r in report["chain"]["ragged"] + report["chain"]["shapes"])
    kernels.append({
        "name": fc.CHAIN, "route": "cuda", "source": CHAIN_SOURCE,
        # fused_conv3x3_chain; the same function as fused_conv3x3_chain_wl (:502)
        "replaces": "simple_vae_rs_tpu/ops/pallas_conv.py:581",
        "also_replaces": "simple_vae_rs_tpu/ops/pallas_conv.py:502",
        "launches": sum(len(v) for v in chain_paths.values()),
        "launches_by_path": {k: len(v) for k, v in chain_paths.items()},
        "max_abs_err": chain_err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("operations" if tot["ops"] / PEAK_F32_TC_FLOPS > tot["bytes"] / PEAK_BYTES
                     else "bytes"),
        "library_ms": None,  # no single PyTorch call computes the chain
        "per_layer_kernels_ms": tot["per_layer_ms"], "library_calls_per_layer_ms": tot["library4_ms"],
        **tc_columns(tot), "bound_cuda_core_ms": tot["bound_cuda_core_ms"],
    })
    for k in kernels:
        k["launches_on_new_paths"] = {path: {key: v for key, v in counts.items()
                                             if key.split(" ")[0] == k["name"]}
                                      for path, counts in family_launches.items()}
        k["launches_on_new_paths"] = {p: c for p, c in k["launches_on_new_paths"].items() if c}
    kernels += bf16_kernels
    for name, tot in bf16_int8_totals.items():
        kernels.append({
            "name": name + BF16_SOURCE_TAG, "route": "cuda", "source": INT8_SOURCE,
            "replaces": REPLACES[name], "launches": sum(bf16_int8_launches[name].values()),
            "launches_by_path": bf16_int8_launches[name], "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["ops"] / (PEAK_INT8_OPS if name in TC_INT8
                                                       else PEAK_F32_FLOPS)
                         > tot["bytes"] / PEAK_BYTES else "bytes"),
            "library_ms": tot["library_ms"],
            **({"bf16_kernel_ms": tot["bf16_kernel_ms"], "cudnn_bf16_ms": tot["cudnn_bf16_ms"],
                "gemm_ms": tot["gemm_ms"] or None, "share_of_bound": tot["bound_ms"] / tot["ms"]}
               if name in TC_INT8 else {}),
            **({"device_ms": tot["device_ms"] or None} if name != "act_quant" else {}),
        })
    kernels.append(bf16_chain_entry)
    if len(kernels) != 25 or any(k["launches"] <= 0 for k in kernels):
        raise AssertionError("a kernel of the main paths was launched no time: "
                             + str({k["name"]: k["launches"] for k in kernels}))
    # F1-F5. the training run: fit, evaluation, checkpoints, resume, remat,
    # serving from the checkpoint (after the kernels line's counts are taken)
    torch.cuda.empty_cache()
    fit_phase(report, card)
    # G1-G7. training from tiles on disk through the command line, evaluate,
    # doctor; H1-H3. whole rasters in process, through the raster command and
    # over HTTP (G's tree and checkpoint)
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(ROOT, "build"))
    try:
        cli_phase(report, card, tmp)
        torch.cuda.empty_cache()
        h_paths = raster_phase(report, card, tmp)
        torch.cuda.empty_cache()
        # J1-J3. the checkpoint tools and the artifact, on G's checkpoint
        j_paths = export_phase(report, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in kernels:
        k["launches_phase_h"] = {path: counts[k["name"]] for path, counts in h_paths.items()
                                 if counts.get(k["name"])}
        k["launches_phase_j"] = {path: counts[k["name"]] for path, counts in j_paths.items()
                                 if counts.get(k["name"])}
    for name in ("fused_conv3x3_bn_relu", "fused_conv4x4s2_bn_relu", "fused_convT4x4s2_bn_relu",
                 "quantize_stochastic", "int8_conv3x3_bn_relu", "int8_convT4x4s2_bn_relu",
                 "act_absmax", "act_quant"):
        if not any(name in counts for counts in h_paths.values()):
            raise AssertionError(f"phase H launched {name} no time")
    if not any(BF16_SOURCE_TAG + "_" in k for counts in h_paths.values() for k in counts):
        raise AssertionError("phase H launched no bfloat16 kernel")
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s; times per kernel are sums over its launches in "
        f"the serving run (super_resolve B=16 + uncertainty N=1000), one train step and "
        f"one val step (B=512); for the int8 kernels over the int8 serving run and the "
        f"DownBlock path (the _bf16 ones over B8's), an int8 conv's time including its "
        f"absmax pass; "
        f"launches_by_path.serving_int8 of a float32 kernel counts its launches in the int8 "
        f"serving run, whose times its sums leave out, as they leave out launches_on_new_paths "
        f"(the VAE and SRVAE runs); for {fc.CHAIN} over the chained runs: serving in float32, "
        f"the Cond_SRVAE val step, the VAE's 1000 draws and val step, the SRVAE's two "
        f"requests and val step; for {fc.CHAIN}_bf16 over B9's chained serving")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
