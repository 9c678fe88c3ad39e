#!/usr/bin/env python3
"""Drive the PyTorch port (``stain2stain_tpu_torch``) end to end on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit and no result line):

1. Device: the card's name and power limit, the torch and CUDA versions.
2. Build: every CUDA kernel of the port from ``stain2stain_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once), with ptxas' report.
   ptxas must report no spills for the kernels of ``SPILL_CHECKED``: the
   bf16 attention kernels, the f32 K1-fwd kernel, the six 3xTF32 kernels of
   the f32 K1-bwd (passes 2 and 3 at d 16, 32, 64), the wgmma kernels of
   K2/K3 and K5, K4, the hash dropout kernel and the LayerNorm-modulate pair
   (its forward on f32 x).
3. K1-fwd (``csrc/attention_fwd.cu``) against its plain PyTorch version on
   the card, output and row log-sum-exp, with the stated tolerances: the
   serving shapes (f32 and bf16), the training shapes (bf16 at 256 px, f32
   at 512 px, with the lse that training saves), ``generate_all_classes``'
   shape (BH 768, f32), the 512-px mask paths' shape (128, 4096, 32, f32,
   with the lse), a rank's 512-px shape of phase 28 (48, 4096, 32, f32, with
   the lse), d 16 and d 64 (both dtypes), d 72 (bf16 alone: DiT-XL/2's
   training shape (512, 1024, 72), a ragged T and peaked logits), T 4096,
   ragged T, peaked logits (q × 8); times of the kernel
   (per call, ``ms``, and queued device time, ``queued_ms``, see
   :func:`cuda_queued_ms`), the plain version and
   ``scaled_dot_product_attention`` (a yardstick only, never used by the
   port) beside the bound computed from the shape.
4. K1-bwd (``csrc/attention_bwd.cu``) against its plain version (the
   explicit backward, itself checked against torch autograd through the
   plain forward) at the same kinds of shapes (f32 first at the 512-px f32
   training shape (96, 4096, 32), then a rank's of phase 28 (48, 4096, 32)
   and the mask paths' (128, 4096, 32); d 72 in bf16 as in phase 3),
   through both routes: the lse from K1-fwd
   given (training's route) and recomputed; each run twice, equal bit for
   bit; times of both routes, the plain version and the backward of
   ``scaled_dot_product_attention`` (yardstick only) beside the bound.
5. The serving path at full width: ``configs/`` composed through the port's
   config code, the flagship UNet (``model=conditional_flow_matching``, about
   71 M parameters) from a fixed seed with every parameter jittered (ADM
   zero-inits the output convs, which would make ``generate`` the identity
   and hide a faulty kernel), ``TranslationServer`` (tile 256, overlap 32,
   batch 16, euler with 2 steps) behind ``serve_forever`` on 127.0.0.1, a
   few PNG requests over HTTP, then one tile batch through the config's own
   dopri5 solver. The launch counts are zeroed just before and read just
   after: K1 must have launched once per velocity evaluation.
6. One f32 UNet forward on the card (TF32 off) against the same weights
   through the plain path on the CPU.
7. The training path at full width: ``train(cfg)`` of
   ``stain2stain_tpu_torch.train`` in process on
   ``experiment=quality_synthetic_256`` (flagship UNet, batch 32 at 256 px,
   bf16-mixed) cut to 256 training tiles and one epoch: 8 optimizer steps,
   validation, checkpoints, test from the best checkpoint. The launch counts
   are zeroed just before and read just after: K1-bwd must have launched once
   per backward pass, K1-fwd once per net forward.
8. ``train-f32``: the same entry point in f32 at the reference's 512-px
   operating point (``trainer.precision=32``, 512-px tiles, batch 6, 48
   training tiles: 8 steps, validation, checkpoints, test), torch's default
   TF32 settings: K1-fwd and K1-bwd in f32 (the 3xTF32 backward), once per
   net forward and once per step; K2–K5 never.
9. One f32 train step of the flagship (batch 2, 256 px, dropout 0) on the
   card with TF32 off against the same step through the plain path on the
   CPU: loss and every parameter gradient.
10. K2–K5 (``csrc/conv3x3_fwd.cu`` as K2 and K3, ``csrc/prologue_grad.cu``,
    ``csrc/conv3x3_wgrad.cu``) against their plain versions on the card at
    the flagship's first-level shape (B 32, 256², C = D = 128), its
    largest-C shape (B 32, 32², C 1024 → D 512) and a ragged one (B 3, H 20,
    W 48, C 384 → D 256: H past the last whole row tile, the level-0
    skip-concat width), bf16, affine + SiLU, dropout 0.1, with the stated
    tolerances; times of each kernel, its plain version and the cuDNN call
    for the same function (a yardstick only, never used by the port) beside
    the bound computed from the shape; K4 and K5 run twice and must agree
    bit for bit; K2 with an identity centre tap must reproduce
    ``hash_mask``'s dropout mask bit for bit. Then the sweep: K2, K3 and K5
    against cuDNN, and K4 (per call and queued) against its bound, at each
    distinct conv shape of the fused flagship (recorded from one net
    forward), with its launches per train step and the launch-weighted
    totals per step.
11. The training path of phase 7 again with ``+model.net.fused_conv=true``
    on the same synthetic data: K2 must have launched 44 times per net
    forward (22 ResBlocks × 2 convs) and K3, K4, K5 44 times per backward
    pass; the runs of phases 7 and 8 must have launched none of them.
12. One bf16 train step of the fused flagship (batch 2, 256 px, dropout 0.1
    from one generator seed) on the card (K2–K5) against the same step on
    the CPU (their plain versions): loss and every parameter gradient; and
    the fused against the unfused net on the card, same weights, eval.
13. ``train-remat``: phase 8's operating point with
    ``+model.net.use_checkpoint=level`` through the entry point (K1-fwd once
    per forward plus once per step: the mid block's recompute); each mode of
    ``REMAT_MODES`` through the trainer's step (peak memory, median step
    time, K1 launches a step); one f32 step at batch 2 (TF32 off,
    deterministic cuDNN, dropout 0.1) under each mode against the step
    without remat (loss, every gradient, the generator's state); then phase
    11's fused run with level remat (K2 44 per forward plus 44 per step: all
    22 fused ResBlocks lie in regions).
14. ``any2any``: ``experiment=any2any_he_amyloid`` through the entry point on
    synthetic domain folders (f32, level remat, batch 32 cut from 128, 8
    steps, validation, checkpoints, test); its task, jittered, behind the
    class-conditioned server over HTTP (a request per class, the outputs
    differ, K1-fwd once per velocity evaluation); ``generate_all_classes`` on
    16 tiles (K1-fwd at BH 768) against ``generate`` per class, TF32 off.
15. ``eval``: on phase 7's best checkpoint, ``eval`` (its test loss),
    ``eval_quality`` (one JSON line), SSIM/PSNR and the Inception features on
    the card against the CPU, ``infer_wsi``, ``infer_simple_flowmatching`` and
    ``infer_any2any`` (on phase 14's checkpoint).
16. ``train-masked-conditioned``: ``experiment=he2ihc_masked_conditioned``
    (the toggled mask-conditioned task: a 4 → 3 net with attention at level 3
    and in the mid block, six K1 layers a forward at (128, 4096, 32)) through
    the entry point at the reference's operating point (f32, 512 px, batch
    8, one card) on a synthetic masked tree read by the experiment's own CSV
    datamodule (its first 8 batches of 128 tiles): 8 steps, validation,
    checkpoints, test; K1-fwd six times per net forward, K1-bwd six times a
    step, K2–K5 never. Then
    ``infer_conditional`` on its checkpoint with the mask and with
    ``+zero_mask=true`` (the generated panels differ), the toggled task
    behind the server (one request on the 1000×900 region), and the
    conditioned task refused without a mask.
17. ``train-masked``, ``train-roi``, ``train-pos-neg``: the masked,
    ROI-Charbonnier and positive/negative studies (the plain flagship net,
    one K1 a forward at (128, 4096, 32)) at f32, 512 px, batch 8, 4 steps,
    one val and one test batch; the ROI path logs ``flow_loss`` and
    ``roi_charbonnier``, the pos/neg path draws negatives.
18. One f32 train step of the mask-conditioned net (batch 2, 256 px,
    dropout 0) on the card with TF32 off against the CPU: loss and every
    gradient, with K1-fwd and K1-bwd six times each.
19. ``train-multitask``: ``experiment=multitask_he2ihc_amyloid`` (the
    shared encoder, features 64…1024, with the flow and binary segmentation
    decoders, 512…64; 44,325,188 parameters) through the entry point at f32,
    512 px, batch 16 (the reference's 32 a device cut for one card: the
    encoder runs on 2B images) under the reference's BatchNorm, on phase
    16's masked tree: 8 steps, validation (``dice_coef``, ``iou``),
    checkpoints with every BatchNorm's running statistics (updated once a
    step), test from the best one. Then ``infer_multitask_multiclassloss``
    on its checkpoint (the predicted mask panel binary) and the task behind
    the server (one request on the 1000×900 region).
20. ``train-multitask-multiclass``:
    ``experiment=gray_matter/multitask_he2ihc_gray_matter`` (2 classes) at
    its operating point (f32, 256 px, batch 32) under BatchNorm on a
    synthetic tree with 2-class masks read by the experiment's own
    ``PairedMulticlassDataModule``: 8 steps, validation (per-class Dice and
    IoU, averaged), test; then ``infer_multitask_multiclassloss`` (ids in
    {0, 1}).
21. One f32 train step of the full-width multitask net (batch 2, 256 px) on
    the card (TF32 off, deterministic cuDNN) against the CPU, under GroupNorm
    (the configs' default) and BatchNorm: loss, every gradient, the running
    statistics. No phase of 19–21 launches K1–K5 (the multitask nets have no
    attention; their convs are cuDNN's, as the JAX package's are XLA's): each
    records 0 launches of every kernel.
22. ``train-wandb``: phase 7's path (the flagship, batch 32, 256 px,
    bf16-mixed) under ``logger=wandb logger.wandb.name=chip-smoke`` with no
    wandb client and ``WANDB_CACHE_DIR`` in the work directory, cut to 4
    steps: the logger's JSONL holds the step metrics and a
    ``model_artifact`` record with its ``artifact_ref``, and the cache holds
    the best checkpoint byte for byte; K1-fwd and K1-bwd (bf16) as in phase 7,
    one K1-bwd a step.
23. ``train-resume``: the same overrides with
    ``ckpt_path=wandb-artifact://stain2stain/model-chip-smoke:latest``,
    ``trainer.max_epochs=2`` and ``+trainer.profiler=advanced``:
    ``global_step`` goes on from 4 to 8, the first resumed step starts from
    the checkpoint's weights bit for bit, and the Chrome trace the trainer
    writes under ``<default_root_dir>/profile`` names the K1-fwd and K1-bwd
    kernels as many times as their launch counters counted over the profiled
    window; the median step with and without the profiler.
24. ``serve-mask-bound`` (run after phase 16's ``infer_conditional``, on its
    trained net): the mask-conditioned task behind
    ``TranslationServer(task, …, mask=zeros)`` (1000×900 region, batch 16,
    256-px tiles, K1-fwd f32 six times per velocity evaluation): the request's
    latency, the served image against ``translate_large_image`` over
    ``task.generate(x, mask=zeros)`` within 1e-6, a ones mask another image.
25. ``mnist-sweep``: ``-m hparams_search=mnist_optuna experiment=example
    trainer.accelerator=gpu`` through the training entry point on the
    synthetic digits (the config's 20 trials of 10 epochs unless
    ``MNIST_SWEEP_CUT`` says otherwise), journaled: every trial recorded, each
    trial's ``val/acc_best`` the running max of ``val/acc``, the best value
    and its parameters; K1–K5 never launch.
26. ``dropout-bits``: ``FastDropout(0.1, impl="bits")`` on a (32, 128, 256,
    256) bf16 tensor on the card: values {0, 1/(1-rate)}, the keep fraction
    within 5σ of 0.9, the backward's mask the forward's, the same mask from
    the same generator state; its time beside ``hash_dropout``'s.
27. ``train-ddp``: ``python -m stain2stain_tpu_torch.train`` in a
    subprocess with torchrun's launch variables for a world of 1 (NCCL, the
    net under ``DistributedDataParallel``) at phase 8's operating point plus
    ``trainer=ddp`` (he2ihc_CF_new_data's: f32, 512 px, global batch 6), 8
    steps, validation, checkpoints, test: its first loss equals phase 8's
    within 1e-5 relative; K1-fwd once a forward, K1-bwd once a step, counted
    over the fit by a callback (``ddp_probe``); the step time and peak
    memory beside phase 8's.
28. ``train-ddp-2rank``: two processes share the card, each joining a gloo
    group itself (NCCL refuses two ranks on one device) and running
    ``train.train(cfg)`` with ``trainer=ddp``: 3 tiles a rank (K1 at
    (48, 4096, 32)), dropout 0, 4 steps, validation, checkpoints, test. The
    ranks' parameters are bit-identical after every step; the step-1
    all-reduced gradient is within 1e-4 × max|g| of one process's on the
    same global batch; rank 1 writes no file; the last checkpoint resumes
    in one process with rank 0's weights; each rank's peak and the time of
    a gradient-sized gloo all-reduce. Then ``trainer=fsdp trainer.fsdp=2``
    for 2 steps: the moments sharded (``ShardedOptimizer``), the ranks equal.
29. ``serve-sealed`` (run right after phase 6, on phase 5's net):
    ``serving.export_generator`` seals the jittered flagship for batch 16 at
    256 px under euler with 2 steps, under the config's dopri5 (one
    ``while_loop`` node) and as a bf16 ``fused_conv`` net with the same
    weights; the ``.pt2`` files are loaded by ``serving.load_generator`` in
    a process of their own that imports no model code and run on the tile
    batch: within 1e-6 (dopri5: 1e-5) of the direct ``generate``, K1-fwd
    (and K2: 44 a velocity evaluation) launched as often as on the direct
    path; the export seconds, the program's MB, the load seconds and the
    loaded and direct tile-batch ms.
30. ``convert-ckpt``: a Lightning-layout ``.ckpt`` of the same net through
    ``python -m stain2stain_tpu_torch.convert_ckpt``; ``load_task`` on the
    directory generates the tile batch bit for bit as the source task did;
    ``export_model`` on the directory writes phase 29's euler program (every
    member of the archive the same bytes).
31. ``data-sanity``: the entry point of ``stain2stain_tpu_torch.data_sanity``
    (``main(argv)``) on a synthetic masked tree (exit 0, no error) and on a
    copy without one tile (exit 1, the file in ``missing_files``).
32. ``train-s2b`` (after phase 25, under the expandable segments set before
    phase 16): phase 8's operating point with ``+model.net.s2b_conv=2``: its
    first loss within 1e-5 relative of phase 8's, the same K1 launches; its
    step and peak memory beside phase 8's.
33. ``quality-control`` (after phase 32): the port's smoke-scale quality
    control (``stain2stain_tpu_torch.quality``, the counterpart of JAX's
    ``tests/test_quality_control.py``: a 16-channel UNet, 32 px, 64
    noise-free pairs, 150 epochs, f32) on the card at seeds 0-3, one process
    a seed, all at once: JAX's gates on the mean over the seeds (val/loss
    below 0.02, the 8- and 50-step SSIM at most 0.05 below the 2-step, the
    50-step above 0.6); each seed's SSIMs and the phase's seconds; K1-fwd
    and K1-bwd f32 in the mid block.
34. ``quality-real``: ``scripts/torch_gen_quality_tiles.py`` writes the
    1152-tile tree of ``experiment=quality_real_256``, which trains on it
    through the entry point at full width (the plain ``PairedDataModule``,
    its device cache, bf16-mixed, batch 32) for one epoch (16 steps,
    validated) and tests; the device cache's decoded train tiles equal a
    cv2 decode of the PNGs bit for bit; ``eval_quality`` at 2 euler steps on
    its checkpoint (two test batches of 16) prints one JSON line (SSIM in
    [-1, 1], a finite PSNR), K1-fwd once a batch.
35. A ``kernels`` JSON line (K1-fwd, K1-bwd, K2–K5, the hash dropout and the
    LayerNorm-modulate pair,
    each with ``ms`` and ``queued_ms``, and launches by path, the multitask
    paths', phases 22–25's, 27–28's, 29–32's and 33–34's included), the
    seconds of every phase, the card line, and ``{"ok": true, "device":
    ...}`` as the last line.
36. ``dropout-kernel`` (run after phase 4): ``hash_dropout``'s kernel
    (``csrc/dropout.cu``) against the plain ``x * hash_mask(...)``, forward
    and gradient, bit for bit, at the mask net's four dropout shapes, an odd
    shape and a non-contiguous input, in float32, bfloat16 and float16, at
    four seeds and two rates, with the largest absolute difference; its
    times against the plain chain and its bound at the mask shapes in
    float32 (``phase_dropout_kernel``). Each train phase's
    ``dropout_launches`` must be its net's active dropout layers x (2 x steps
    + the remat recomputes) without fused_conv, and 0 with it.
37. ``train-dit`` (after phase 8, on its 512-px data): the DiT (``models/dit.py``)
    through the same entry point under ``bf16-mixed``: DiT-XL/2's widths (hidden
    1152, 16 heads of 72, MLP 4608, 16-px patches of 512-px tiles: T 1024) with
    depth cut to 4 blocks, batch 6, 8 steps, validation, checkpoints, test; K1 in
    bf16 at head dim 72, K1-fwd once per block of each net forward and K1-bwd
    once per block a step, its own counts zeroed just before the run; K2–K5 and
    the dropout kernel never. The LayerNorm-modulate kernels: the forward
    (2 x blocks + 1) times a net forward, the backward as often a step; every
    other train path launches neither.
38. ``ln-modulate-kernel`` (run after phase 36): the DiT's LayerNorm-modulate
    kernels (``csrc/layer_norm_modulate.cu``) against the plain chain in f32,
    forward and every gradient, twice bit for bit, one launch each a call, at
    ``LN_MODULATE_CASES``; a ``ValueError`` for C not a multiple of 8 and for
    float64 on the card; their times against their bound, the plain chain and
    torch's ``F.layer_norm`` chain at the DiT cell's shape
    (``phase_ln_modulate_kernel``).

With ``--profile`` it also profiles a tile batch and a request, and a train
step of each path (``phase_profile_train``), the binary multitask study's
under BatchNorm and under GroupNorm among them.

It exits non-zero, printing no result, when no CUDA card is present or when
the port's package is not beside it.
"""

from __future__ import annotations

import csv
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores (the f32 K1-fwd keeps f32 products on the FP32
# pipes; every kernel's bound_ms for f32 inputs counts f32 work there), TF32
# tensor cores (the f32 K1-bwd runs its products as 3xTF32 there), HBM3
# bandwidth. The exponential rate comes from the card itself: 16 MUFU ex2
# results per clock per SM at the card's maximum SM clock.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 494e12}
PEAK_BYTES_PER_S = 3.35e12
MUFU_EX2_PER_CLK_PER_SM = 16

TOL = {"float32": 5e-5, "bfloat16": 8e-3}  # max abs error vs the plain version
# K1-fwd's row log-sum-exp (f32 either way; the logits differ only in
# summation order), max abs error vs the plain version's
LSE_TOL = 1e-4
UNET_REL_TOL = 2e-4  # f32 card vs CPU, TF32 off: summation order only
# K1-bwd: max abs error over dq, dk, dv as a multiple of max|ref|. f32: the
# sums over T keys and queries run in another order (measured ~2e-6); bf16:
# the outputs are rounded to bf16, whose ulp is 2^-7 of the value, so up to
# about 0.4 % of max|ref| plus the f32 summation order.
BWD_REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# flagship f32 gradients, card (TF32 off) vs CPU, as a multiple of the
# largest |gradient|: summation order over batch x 65536 pixels per weight
GRAD_REL_TOL = 1e-3
# K2–K5 against their plain versions, max abs error as a multiple of max|ref|.
# bf16 outputs (K2, K3, K4's dx): rounded to bf16 (ulp 2^-8..2^-7 of the
# value) after f32 sums taken in another order. f32 outputs (dscale, dshift,
# dW, dbias): the same bf16 products summed in f32 in another order, over up
# to 2.1 M pixels.
CONV_REL_TOL = {"bf16": 1e-2, "f32": 1e-3}
# the multitask net's BatchNorm running statistics after one step, card vs
# CPU, max abs: 1 % of a batch mean or variance summed in another order
BN_STATS_TOL = 1e-5
# under BatchNorm, the card's f32 multitask gradients against the CPU's
# float64 step: at most this many times as far as the CPU's own f32 step
# (two f32 computations, each within that distance)
F32_FLOOR_FACTOR = 2.0
# the fused flagship's bf16 gradients, card vs CPU, as a multiple of the
# largest |gradient|: bf16 activations round at the same points on both sides,
# but the sums run in another order and a rounding flip propagates
FUSED_GRAD_REL_TOL = 3e-2
# the fused against the unfused flagship, same weights, bf16 eval forward on the
# card, as a multiple of max|unfused|: the two round to bf16 at other points
# (the fused conv adds its bias in f32), one ulp (2^-8) per block over 22 blocks
FUSED_EVAL_REL_TOL = 3e-2
FUSED_OVERRIDE = "+model.net.fused_conv=true"
FLAGSHIP_FUSED_CONVS = 44  # 22 ResBlocks x 2 fused convs per net forward
# the server with a bound mask against translate_large_image over task.generate(x, mask) on the same card: the same
# kernels on the same inputs in the same order, so the same floats up to the PNG decode's float32 round trip
BOUND_MASK_TOL = 1e-6
# the template's sweep (configs/hparams_search/mnist_optuna.yaml: 20 trials of experiment=example, 10 epochs) on the
# synthetic digits, through the entry point; the config tree is not printed (once a trial, 20 times)
MNIST_SWEEP = ["-m", "hparams_search=mnist_optuna", "experiment=example", "trainer.accelerator=gpu",
               "extras.print_config=false"]
# the config's 20 trials cut to 10 to keep the script inside its time limit with phases 29-32; every trial of the
# full study reached val/acc 1.0 on the synthetic digits, so the cut study checks the same machinery
MNIST_SWEEP_CUT: list = ["sweeper.n_trials=10"]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int, warmup: int = 2) -> float:
    """Median per-call milliseconds, each call bracketed by CUDA events. The
    card may wait for the host inside the bracket (the wrapper's checks,
    allocations and launches): :func:`cuda_queued_ms` leaves that out."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


QUEUE_SLEEP_CYCLES = 100_000_000  # about 50 ms at the H100's SM clock


def cuda_queued_ms(fn, calls: int = 20, warmup: int = 2) -> float:
    """Device milliseconds per call of ``calls`` back-to-back calls between two
    CUDA events, divided by ``calls``. A sleep kernel ahead of the first event
    holds the card while the host enqueues every call, so the card never waits
    for the host between the events: the queued device time."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def attention_bound(bh: int, t: int, d: int, dtype: str, exp_per_s: float, lse: bool = False) -> dict:
    elem = 2 if dtype == "bfloat16" else 4
    # q, k, v read, o (and the f32 lse) written
    bytes_ms = (4 * bh * t * d * elem + 4 * bh * t * lse) / PEAK_BYTES_PER_S * 1e3
    flop_ms = 4 * bh * t * t * d / PEAK_FLOPS[dtype] * 1e3  # q·kᵀ and p·v
    exp_ms = bh * t * t / exp_per_s * 1e3  # one exponential per logit
    ops_ms = max(flop_ms, exp_ms)
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "flop_ms": flop_ms,
        "exp_ms": exp_ms,
    }


# the kernels ptxas must compile without spills: the bf16 attention kernels of
# K1-fwd and K1-bwd, the register-tiled f32 K1-fwd, the 3xTF32 passes of the
# f32 K1-bwd, the wgmma kernels of K2/K3 and K5, K4, the hash dropout, and the
# LayerNorm-modulate backward and its forward on f32 x (the DiT's residual
# stream; on bf16 x at 4 and 5 vectors a lane ptxas keeps one 4-byte value on
# the stack by its own choice, at 56 and 64 registers)
SPILL_CHECKED = {
    "attention_fwd.cu": ("mma_kernel", "f32_kernel"),
    "attention_bwd.cu": ("mma_kernel", "tf32_kernel", "prep"),
    "conv3x3_fwd.cu": ("conv3x3_fwd_kernel",),
    "prologue_grad.cu": ("prologue_grad_kernel",),
    "conv3x3_wgrad.cu": ("conv3x3_wgrad_kernel",),
    "dropout.cu": ("hash_dropout_kernel",),
    "layer_norm_modulate.cu": ("ln_modulate_fwd_kernelIf", "ln_modulate_bwd_kernel"),
}


def checked_spills(build_logs: dict) -> dict:
    """Spill-store bytes of every kernel of ``SPILL_CHECKED`` (K1-bwd's prep
    pass in its bf16 instances only), by source and mangled name, from ptxas'
    report (``-Xptxas -v``)."""
    import re

    spills = {}
    for src, keys in SPILL_CHECKED.items():
        name = None
        for line in build_logs.get(src, "").splitlines():
            found = re.search(r"entry function '(\S+)'", line)
            if found:
                name = found.group(1)
            found = re.search(r"(\d+) bytes spill stores", line)
            if not (found and name and any(k in name for k in keys)):
                continue
            if src == "attention_bwd.cu" and "prep" in name and "bfloat16" not in name:
                continue  # K1-bwd's f32 prep pass: SIMT, not checked
            spills[f"{src}:{name}"] = int(found.group(1))
    return spills


def phase_kernels(exp_per_s: float) -> dict:
    import torch
    import torch.nn.functional as F

    from stain2stain_tpu_torch.ops.attention import fused_attention, fused_attention_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("K1: TF32 off for matmul and cuDNN (the plain f32 version runs in full f32)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (BH, T, d, dtype, q scale, lse as its caller asks, what). Peaked logits
    # (q x 8) make the online softmax rescale; their v is scaled by 1/8 so the
    # near one-hot outputs keep the unit range the absolute bf16 TOL is set for
    # (one bf16 ulp of a value in [2, 4) is 0.016).
    cases = [
        (256, 1024, 32, "float32", 1.0, False, "256-px serving shape, f32 (the config's dtype: the main path)"),
        (96, 4096, 32, "float32", 1.0, True,
         "512-px f32 training shape (batch 6, 16 heads), lse saved: train-f32's call"),
        (48, 4096, 32, "float32", 1.0, True,
         "512-px f32 training shape a rank of 2 (global batch 6, 3 a rank), lse saved: train-ddp-2rank's call"),
        (128, 4096, 32, "float32", 1.0, True,
         "512-px f32 mask training shape (batch 8, 16 heads), lse saved: the mask paths' call, six a forward "
         "on the mask-conditioned net"),
        (256, 1024, 32, "bfloat16", 1.0, False, "256-px serving shape, bf16"),
        (512, 1024, 32, "bfloat16", 1.0, True, "256-px training shape (batch 32), bf16, lse saved: training's call"),
        (256, 1024, 16, "bfloat16", 1.0, False, "d 16, bf16"),
        (128, 1024, 64, "bfloat16", 1.0, False, "d 64, bf16"),
        (64, 4096, 32, "bfloat16", 1.0, False, "512-px mid block, bf16"),
        (64, 1024, 32, "bfloat16", 8.0, True, "peaked logits (q x 8), bf16"),
        (16, 1000, 32, "float32", 1.0, False, "ragged T, f32"),
        (16, 1000, 32, "bfloat16", 1.0, False, "ragged T, bf16"),
        (256, 1024, 16, "float32", 1.0, False, "d 16, f32"),
        (128, 1024, 64, "float32", 1.0, False, "d 64, f32"),
        (64, 1024, 32, "float32", 8.0, True, "peaked logits (q x 8), f32"),
        (768, 1024, 32, "float32", 1.0, False,
         "generate_all_classes' shape (3 classes x 16 tiles x 16 heads), f32: any2any's all-class call"),
        (16, 256, 32, "float32", 1.0, True,
         "the quality control's training shape (32 px, batch 16, one 32-wide head at 16 px), f32, lse saved: "
         "quality-control's training call"),
        (8, 256, 32, "float32", 1.0, False,
         "the quality control's 8 validation and test tiles, f32: quality-control's evaluation call"),
        (512, 1024, 72, "bfloat16", 1.0, True,
         "DiT-XL/2 at 512 px (batch 32, 16 heads of 72, T 1024), bf16, lse saved: the DiT training call"),
        (48, 1000, 72, "bfloat16", 1.0, False, "ragged T, d 72, bf16"),
        (64, 1024, 72, "bfloat16", 8.0, True, "peaked logits (q x 8), d 72, bf16"),
    ]
    results = []
    for bh, t, d, dtype, peak, with_lse, what in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen) for _ in range(3))
        q, k, v = (q * peak).to(dt), k.to(dt), (v / peak).to(dt)
        scale = 1.0 / math.sqrt(d)
        out, lse = fused_attention(q, k, v, scale, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fused_attention_reference(q, k, v, scale, return_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype] and lse_err <= LSE_TOL
        ms = cuda_ms(lambda: fused_attention(q, k, v, scale, return_lse=with_lse), repeats=20)
        queued_ms = cuda_queued_ms(lambda: fused_attention(q, k, v, scale, return_lse=with_lse))
        plain_ms = cuda_ms(lambda: fused_attention_reference(q, k, v, scale, return_lse=with_lse), repeats=5)
        # (1, BH, T, d): the 4-D layout SDPA's fused backends take
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale), repeats=20
        )
        row = dict(bh=bh, t=t, d=d, shape=[bh, t, d], dtype=dtype, q_scale=peak, lse=with_lse, what=what,
                   max_abs_err=err, tol=TOL[dtype], lse_max_abs_err=lse_err, lse_tol=LSE_TOL,
                   ok=ok, ms=ms, queued_ms=queued_ms, plain_ms=plain_ms, library_ms=library_ms,
                   **attention_bound(bh, t, d, dtype, exp_per_s, with_lse))
        log("K1 " + json.dumps(row))
        results.append(row)
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return {"cases": results}


def attention_bwd_bound(bh: int, t: int, d: int, dtype: str, exp_per_s: float) -> dict:
    elem = 2 if dtype == "bfloat16" else 4
    # q, k, v, o, do read, the f32 lse read; dq, dk, dv written
    bytes_ms = (8 * bh * t * d * elem + 4 * bh * t) / PEAK_BYTES_PER_S * 1e3
    flop_ms = 10 * bh * t * t * d / PEAK_FLOPS[dtype] * 1e3  # s, dv, dp, dq, dk products
    exp_ms = bh * t * t / exp_per_s * 1e3  # one exponential per p
    ops_ms = max(flop_ms, exp_ms)
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "flop_ms": flop_ms,
        "exp_ms": exp_ms,
        # the kernel's own design (no atomics): s and dp computed in both the
        # dk/dv and the dq pass, so seven products and two exponentials per p
        "design_bound_ms": max(bytes_ms, 1.4 * flop_ms, 2 * exp_ms),
        # f32: the five products as 3xTF32 (three tensor-core products each)
        "tf32x3_bound_ms": (3 * 10 * bh * t * t * d / PEAK_FLOPS["tfloat32"] * 1e3
                            if dtype == "float32" else None),
    }


def phase_k1_bwd(exp_per_s: float) -> dict:
    import torch
    import torch.nn.functional as F

    from stain2stain_tpu_torch.ops.attention import (
        fused_attention,
        fused_attention_backward,
        fused_attention_backward_reference,
        fused_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("K1-bwd: TF32 off for matmul and cuDNN (the plain f32 version runs in full f32)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (BH, T, d, dtype, q scale, what)
        (512, 1024, 32, "bfloat16", 1.0, "256-px training shape (batch 32, 16 heads), bf16: the main path"),
        (96, 4096, 32, "float32", 1.0, "512-px f32 training shape (batch 6, 16 heads): the train-f32 path"),
        (48, 4096, 32, "float32", 1.0, "512-px f32 training shape a rank of 2 (3 a rank): the train-ddp-2rank path"),
        (128, 4096, 32, "float32", 1.0,
         "512-px f32 mask training shape (batch 8, 16 heads): the mask paths, six a step on the mask-conditioned net"),
        (512, 1024, 32, "float32", 1.0, "256-px training shape, f32"),
        (64, 4096, 32, "bfloat16", 1.0, "512-px mid block at batch 4, bf16"),
        (256, 1024, 16, "bfloat16", 1.0, "d 16, bf16"),
        (128, 1024, 64, "bfloat16", 1.0, "d 64, bf16"),
        (64, 1024, 32, "bfloat16", 8.0, "peaked logits (q x 8), bf16"),
        (256, 1024, 16, "float32", 1.0, "d 16, f32"),
        (128, 1024, 64, "float32", 1.0, "d 64, f32"),
        (64, 1024, 32, "float32", 8.0, "peaked logits (q x 8), f32"),
        (16, 1000, 32, "float32", 1.0, "ragged T, f32"),
        (16, 1000, 32, "bfloat16", 1.0, "ragged T, bf16"),
        (16, 256, 32, "float32", 1.0,
         "the quality control's training shape (32 px, batch 16, one 32-wide head at 16 px), f32: quality-control"),
        (512, 1024, 72, "bfloat16", 1.0,
         "DiT-XL/2 at 512 px (batch 32, 16 heads of 72, T 1024), bf16: the DiT training path, 28 a step"),
        (48, 1000, 72, "bfloat16", 1.0, "ragged T, d 72, bf16"),
        (64, 1024, 72, "bfloat16", 8.0, "peaked logits (q x 8), d 72, bf16"),
    ]
    results = []
    for bh, t, d, dtype, peak, what in cases:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(bh, t, d, device="cuda", generator=gen) for _ in range(4))
        q, k, v, do = (q * peak).to(dt), k.to(dt), v.to(dt), do.to(dt)
        scale = 1.0 / math.sqrt(d)
        o, lse = fused_attention(q, k, v, scale, return_lse=True)  # as FusedAttention saves them
        got = fused_attention_backward(q, k, v, o, do, scale, lse)
        again = fused_attention_backward(q, k, v, o, do, scale, lse)
        recomputed = fused_attention_backward(q, k, v, o, do, scale)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        ref = fused_attention_backward_reference(q, k, v, o, do, scale)
        ref_max = max(r.float().abs().max().item() for r in ref)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        err_recomputed = max((a.float() - b.float()).abs().max().item() for a, b in zip(recomputed, ref))
        # the plain version against torch autograd through the plain forward
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(fused_attention_reference(*leaves, scale), leaves, do)
        auto_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(auto, ref))
        del leaves, auto
        tol = BWD_REL_TOL[dtype] * ref_max
        ok = (all(bool(torch.isfinite(g).all()) for g in got + recomputed) and deterministic
              and max(err, err_recomputed, auto_err) <= tol)
        ms = cuda_ms(lambda: fused_attention_backward(q, k, v, o, do, scale, lse), repeats=10)
        queued_ms = cuda_queued_ms(lambda: fused_attention_backward(q, k, v, o, do, scale, lse), calls=10)
        ms_recomputed = cuda_ms(lambda: fused_attention_backward(q, k, v, o, do, scale), repeats=10)
        plain_ms = cuda_ms(lambda: fused_attention_backward_reference(q, k, v, o, do, scale, lse),
                           repeats=3, warmup=1)
        # (1, BH, T, d): the 4-D layout SDPA's fused backends take
        q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(out4, (q4, k4, v4), do[None], retain_graph=True), repeats=10
        )
        row = dict(bh=bh, t=t, d=d, shape=[bh, t, d], dtype=dtype, q_scale=peak, what=what, max_abs_err=err,
                   max_abs_err_recomputed_lse=err_recomputed, autograd_vs_plain=auto_err, deterministic=deterministic,
                   ref_max_abs=ref_max, tol=tol, ok=ok, ms=ms, queued_ms=queued_ms, ms_recomputed_lse=ms_recomputed,
                   plain_ms=plain_ms,
                   library_ms=library_ms, **attention_bwd_bound(bh, t, d, dtype, exp_per_s))
        log("K1-bwd " + json.dumps(row))
        results.append(row)
        del q, k, v, do, o, lse, got, again, recomputed, ref, q4, k4, v4, out4
        torch.cuda.empty_cache()
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"K1-bwd disagrees with its plain version: {bad}")
    return {"cases": results}


def conv_bound(kernel: str, b: int, h: int, w: int, c: int, d: int, exp_per_s: float) -> dict:
    """The least time for one call at (B, H, W, C → D): each input read once,
    each output written once, the operations at the card's peak for their type."""
    px = b * h * w
    if kernel == "K4":  # x, dn read, dx written (bf16); scale, shift read, dscale, dshift written (f32)
        bytes_ = 3 * 2 * px * c + 4 * 4 * b * c
        flop_ms = 14 * px * c / PEAK_FLOPS["float32"] * 1e3  # affine, SiLU', mask, dx, two sums
        exp_ms = px * c / exp_per_s * 1e3  # one exponential per element
        ops_ms = max(flop_ms, exp_ms)
    else:
        bytes_ = {  # activations bf16, weights bf16 read or f32 written, scale/shift/bias f32
            "K2": 2 * px * (c + d) + 2 * 9 * c * d + 4 * (2 * b * c + d),
            "K3": 2 * px * (d + c) + 2 * 9 * c * d,
            "K5": 2 * px * (c + d) + 4 * (2 * b * c) + 4 * (9 * c * d + d),
        }[kernel]
        ops_ms = 2 * px * 9 * c * d / PEAK_FLOPS["bfloat16"] * 1e3  # tensor-core products
    bytes_ms = bytes_ / PEAK_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes_ms": bytes_ms,
        "ops_ms": ops_ms,
    }


def phase_conv_kernels(exp_per_s: float) -> dict:
    """K2–K5 against their plain versions at the flagship's shapes."""
    import torch
    import torch.nn.functional as F

    from stain2stain_tpu_torch.ops import conv
    from stain2stain_tpu_torch.ops.dropout import hash_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("K2-K5: TF32 off for matmul and cuDNN (the plain versions run in full f32)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    rate, seed = 0.1, 1234567
    cases = [
        (32, 256, 256, 128, 128, "flagship first level (B 32, 256 px): the main path's most pixels"),
        (32, 32, 32, 1024, 512, "flagship lowest level (B 32, 32 px): the largest C"),
        (3, 20, 48, 384, 256, "ragged: H 20 (not a multiple of the 8- or 16-row tiles), C 384 (level-0 skip concat)"),
    ]
    rows: dict[str, list] = {"K2": [], "K3": [], "K4": [], "K5": []}
    masks = []

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def record(name, b, h, w, c, d, what, got, ref, kinds, fn, plain_ms, library_ms, extra=None, repeats=10):
        err, ok, ref_max = 0.0, True, 0.0
        for g, r, kind in zip(got, ref, kinds):
            r_max = r.float().abs().max().item()
            e = (g.float() - r.float()).abs().max().item()
            ok = ok and bool(torch.isfinite(g).all()) and e <= CONV_REL_TOL[kind] * r_max
            err, ref_max = max(err, e), max(ref_max, r_max)
        row = dict(name=name, shape=[b, h, w, c, d], what=what, dtype="bfloat16", max_abs_err=err,
                   ref_max_abs=ref_max, tol_rel=[CONV_REL_TOL[k] for k in kinds], ok=ok,
                   ms=cuda_ms(fn, repeats=repeats), queued_ms=cuda_queued_ms(fn),
                   plain_ms=plain_ms, library_ms=library_ms, **(extra or {}),
                   **conv_bound(name, b, h, w, c, d, exp_per_s))
        log(f"{name} " + json.dumps(row))
        rows[name].append(row)

    for b, h, w, c, d, what in cases:
        x = randn(b, h, w, c).to(bf16)
        wt = (randn(3, 3, c, d) / (3.0 * math.sqrt(c))).to(bf16)
        bias = 0.1 * randn(d)
        scale = 1.0 + 0.2 * randn(b, c)
        shift = 0.2 * randn(b, c)
        dy = randn(b, h, w, d).to(bf16)
        kw = dict(scale=scale, shift=shift, act="silu", dropout_rate=rate, seed=seed)
        # the normalized input and weights of the cuDNN yardsticks (channels-last memory)
        z = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
        n_ref = (z * torch.sigmoid(z) * conv.keep_mask(seed, x.shape, rate, "cuda")).to(bf16)
        n_nchw, dy_nchw = n_ref.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        wi_oihw = torch.flip(wt, dims=(0, 1)).permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
        bias16 = bias.to(bf16)

        y = conv.fused_conv3x3(x, wt, bias, **kw)
        torch.cuda.synchronize()
        record("K2", b, h, w, c, d, what, [y], [conv.fused_conv3x3_reference(x, wt, bias, **kw)], ["bf16"],
               lambda: conv.fused_conv3x3(x, wt, bias, **kw),
               cuda_ms(lambda: conv.fused_conv3x3_reference(x, wt, bias, **kw), repeats=3, warmup=1),
               cuda_ms(lambda: F.conv2d(n_nchw, w_oihw, bias16, padding=1), repeats=10))
        del y

        dn = conv.conv3x3_input_grad(dy, wt)
        torch.cuda.synchronize()
        dn_ref = conv.conv3x3_input_grad_reference(dy, wt)
        record("K3", b, h, w, c, d, what, [dn], [dn_ref], ["bf16"],
               lambda: conv.conv3x3_input_grad(dy, wt),
               cuda_ms(lambda: conv.conv3x3_input_grad_reference(dy, wt), repeats=3, warmup=1),
               cuda_ms(lambda: F.conv2d(dy_nchw, wi_oihw, padding=1), repeats=10))
        del dn

        got = conv.prologue_grad(x, dn_ref, **kw)
        again = conv.prologue_grad(x, dn_ref, **kw)
        torch.cuda.synchronize()
        det = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        record("K4", b, h, w, c, d, what, got, conv.prologue_grad_reference(x, dn_ref, **kw),
               ["bf16", "f32", "f32"],
               lambda: conv.prologue_grad(x, dn_ref, **kw),
               cuda_ms(lambda: conv.prologue_grad_reference(x, dn_ref, **kw), repeats=3, warmup=1),
               None, {"deterministic": det})
        rows["K4"][-1]["ok"] &= det
        del got, again, dn_ref

        got = conv.conv3x3_weight_grad(x, dy, **kw)
        again = conv.conv3x3_weight_grad(x, dy, **kw)
        torch.cuda.synchronize()
        det = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        record("K5", b, h, w, c, d, what, got, conv.conv3x3_weight_grad_reference(x, dy, **kw), ["f32", "f32"],
               lambda: conv.conv3x3_weight_grad(x, dy, **kw),
               cuda_ms(lambda: conv.conv3x3_weight_grad_reference(x, dy, **kw), repeats=3, warmup=1),
               cuda_ms(lambda: torch.nn.grad.conv2d_weight(n_nchw, (d, c, 3, 3), dy_nchw, padding=1), repeats=5),
               {"deterministic": det}, repeats=5)
        rows["K5"][-1]["ok"] &= det
        del got, again

        # the mask, bit for bit: K2 with an identity centre tap returns its n
        w_id = torch.zeros(3, 3, c, c, device="cuda", dtype=bf16)
        w_id[1, 1] = torch.eye(c, device="cuda", dtype=bf16)
        m = conv.fused_conv3x3(x, w_id, None, **kw)
        mask = hash_mask(seed, (b, c, h, w), rate, torch.float32, "cuda").permute(0, 2, 3, 1)
        want = (z * torch.sigmoid(z) * mask).to(bf16)
        mask_mismatch = int(((m == 0) != (mask == 0)).sum())
        # the values may differ by one bf16 ulp where SiLU's exponential rounds otherwise
        ulp_violations = int(((m.float() - want.float()).abs() > 2.0 ** -7 * want.float().abs()).sum())
        row = dict(shape=[b, h, w, c], dropped_share=float((mask == 0).float().mean()),
                   mask_mismatches=mask_mismatch, values_beyond_one_ulp=ulp_violations,
                   max_abs_diff=float((m.float() - want.float()).abs().max()))
        row["ok"] = mask_mismatch == 0 and ulp_violations == 0 and 0.09 < row["dropped_share"] < 0.11
        log("K2-mask " + json.dumps(row))
        masks.append(row)
        del x, wt, dy, z, n_ref, n_nchw, dy_nchw, w_oihw, wi_oihw, w_id, m, mask, want
        torch.cuda.empty_cache()

    bad = [r for rs in rows.values() for r in rs if not r["ok"]] + [r for r in masks if not r["ok"]]
    if bad:
        raise AssertionError(f"K2-K5 disagree with their plain versions or the mask: {bad}")
    return {"rows": rows, "masks": masks}


def flagship_fused_convs() -> dict:
    """{(H, W, C, D): K2 launches} of one net forward of the fused flagship at
    256 px (``+model.net.fused_conv=true``), recorded at the wrapper."""
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops import conv

    cfg = compose(REPO / "configs", "train.yaml", [FUSED_OVERRIDE])
    torch.manual_seed(0)
    net = instantiate(cfg.model.net, device="cuda").eval()
    net.dtype = torch.bfloat16  # what bf16-mixed sets: the gate wants bf16 compute
    shapes: dict = {}
    original = conv._launch_conv

    def record(x, wk, *args):  # wk (3, 3, D, C)
        key = (x.shape[1], x.shape[2], x.shape[3], wk.shape[2])
        shapes[key] = shapes.get(key, 0) + 1
        return original(x, wk, *args)

    conv._launch_conv = record  # the K2 wrapper calls the module's global
    try:
        with torch.no_grad():
            net(torch.full((2,), 0.5, device="cuda"), torch.zeros(2, 256, 256, 3, device="cuda"))
    finally:
        conv._launch_conv = original
    del net
    torch.cuda.empty_cache()
    return shapes


def phase_conv_sweep(exp_per_s: float, batch: int = 32) -> dict:
    """K2, K3 and K5 against cuDNN, and K4 against its bound, at every distinct
    conv shape of the fused flagship (batch 32, 256 px), CUDA events only, with
    each shape's launches per train step (one forward, one backward) and the
    launch-weighted totals per step: the "launches x gap" that orders the
    kernel queue. K4 (no library call) also in queued device time."""
    import torch
    import torch.nn.functional as F

    from stain2stain_tpu_torch.ops import conv

    torch.backends.cudnn.allow_tf32 = False
    shapes = flagship_fused_convs()
    if sum(shapes.values()) != FLAGSHIP_FUSED_CONVS:
        raise AssertionError(f"the fused flagship runs {sum(shapes.values())} fused convs, not {FLAGSHIP_FUSED_CONVS}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16 = torch.bfloat16
    keys = ("K2", "K3", "K4", "K4_queued", "K5", "cudnn_K2", "cudnn_K3", "cudnn_K5",
            "bound_K2", "bound_K3", "bound_K4", "bound_K5")
    totals = dict.fromkeys(keys, 0.0)
    rows = []
    for (h, w, c, d), n in sorted(shapes.items()):
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        x = randn(batch, h, w, c).to(bf16)
        wt = (randn(3, 3, c, d) / (3.0 * math.sqrt(c))).to(bf16)
        bias = 0.1 * randn(d)
        dy = randn(batch, h, w, d).to(bf16)
        dn = randn(batch, h, w, c).to(bf16)
        kw = dict(scale=1.0 + 0.2 * randn(batch, c), shift=0.2 * randn(batch, c), act="silu",
                  dropout_rate=0.1, seed=4321)
        x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels-last memory
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        wi_oihw = torch.flip(wt, dims=(0, 1)).permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
        bias16 = bias.to(bf16)
        row = dict(shape=[batch, h, w, c, d], launches_per_step=n,
                   K2=cuda_ms(lambda: conv.fused_conv3x3(x, wt, bias, **kw), repeats=5),
                   K3=cuda_ms(lambda: conv.conv3x3_input_grad(dy, wt), repeats=5),
                   K4=cuda_ms(lambda: conv.prologue_grad(x, dn, **kw), repeats=5),
                   K4_queued=cuda_queued_ms(lambda: conv.prologue_grad(x, dn, **kw)),
                   K5=cuda_ms(lambda: conv.conv3x3_weight_grad(x, dy, **kw), repeats=5),
                   cudnn_K2=cuda_ms(lambda: F.conv2d(x_nchw, w_oihw, bias16, padding=1), repeats=5),
                   cudnn_K3=cuda_ms(lambda: F.conv2d(dy_nchw, wi_oihw, padding=1), repeats=5),
                   cudnn_K5=cuda_ms(lambda: torch.nn.grad.conv2d_weight(x_nchw, (d, c, 3, 3), dy_nchw, padding=1),
                                    repeats=5),
                   **{f"bound_{k}": conv_bound(k, batch, h, w, c, d, exp_per_s)["bound_ms"]
                      for k in ("K2", "K3", "K4", "K5")})
        for k in keys:
            totals[k] += n * row[k]
        log("conv-sweep " + json.dumps(row))
        rows.append(row)
        del x, wt, bias, dy, dn, kw, x_nchw, dy_nchw, w_oihw, wi_oihw, bias16
        torch.cuda.empty_cache()
    total = dict(batch=batch, convs_per_step=sum(shapes.values()), shapes=len(shapes),
                 **{f"{k}_ms_per_step": v for k, v in totals.items()})
    log("conv-sweep-total " + json.dumps(total))
    return {"rows": rows, "total": total}


def _test_image(h: int, w: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [128 + 90 * np.sin(xx / 37.0 + c) * np.cos(yy / 23.0 - c) for c in range(3)], axis=-1
    )
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _png(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def jittered_flagship(cfg):
    """The flagship UNet of ``cfg.model.net`` on the card from seed 0, every
    parameter jittered (std 0.02, generator seed 1)."""
    import torch

    from stain2stain_tpu_torch.config import instantiate

    torch.manual_seed(0)
    net = instantiate(cfg.model.net, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, device=p.device, generator=gen))
    return net


def tile_batch(batch: int = 16, tile: int = 256):
    """Phase 5's dopri5 tile batch: ``batch`` test images in [-1, 1] on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(
        np.stack([_test_image(tile, tile, seed=100 + i) for i in range(batch)]).astype(np.float32) / 127.5 - 1.0
    ).cuda()


def phase_slice(card: str) -> tuple[dict, object]:
    import numpy as np
    import torch
    from PIL import Image

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.server import TranslationServer, serve_forever
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule
    from stain2stain_tpu_torch.wsi import tile_starts

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for serving:
    torch.backends.cudnn.allow_tf32 = True  # f32 matmul, TF32 cuDNN convs
    cfg = compose(REPO / "configs", "infer.yaml", ["model=conditional_flow_matching"])
    net = jittered_flagship(cfg)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"slice: flagship UNet {n_params} parameters on {card}, every parameter jittered (std 0.02)")

    evals = [0]
    net.register_forward_hook(lambda *_: evals.__setitem__(0, evals[0] + 1))
    task = ConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    tile, overlap, batch = 256, 32, 16

    # ---- the main path: counts zeroed just before, read just after --------
    fused_attention.launches = 0
    evals[0] = 0
    t0 = time.perf_counter()
    server = TranslationServer(task, num_steps=2, tile=tile, overlap=overlap, batch=batch)
    warm_s = time.perf_counter() - t0
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(server, "127.0.0.1", 0, ready), daemon=True)
    thread.start()
    requests = []
    try:
        if not ready.wait(30):
            raise RuntimeError("server did not bind")
        base = f"http://127.0.0.1:{server.bound_port}"
        for h, w in [(1000, 900), (256, 256), (700, 520), (1000, 900)]:
            img = _test_image(h, w, seed=h * w)
            body = _png(img)
            n_tiles = len(tile_starts(max(h, tile), tile, tile - overlap)) * len(
                tile_starts(max(w, tile), tile, tile - overlap)
            )
            req = urllib.request.Request(
                f"{base}/translate", data=body, headers={"Content-Type": "image/png"}
            )
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, payload = resp.status, resp.read()
            latency = time.perf_counter() - t1
            out = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
            if status != 200 or out.shape != img.shape:
                raise AssertionError(f"bad response {status} {out.shape} for {img.shape}")
            requests.append(dict(card=card, h=h, w=w, tiles=n_tiles, batches=math.ceil(n_tiles / batch),
                                 latency_s=latency, tiles_per_s=n_tiles / latency,
                                 mean_abs_change=float(np.abs(out.astype(np.float32) - img).mean())))
            log("request " + json.dumps(requests[-1]))
        info = json.loads(urllib.request.urlopen(f"{base}/info", timeout=60).read())
        # finiteness of the float output, in process (a PNG cannot show a NaN)
        direct = server.translate(_test_image(300, 280, seed=5))
        if direct.shape != (300, 280, 3) or not np.isfinite(direct).all():
            raise AssertionError("translate returned a non-finite or misshapen image")
    finally:
        if server.httpd is not None:
            server.httpd.shutdown()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")

    # the config's own solver (dopri5, atol/rtol 1e-4) on one tile batch
    dopri_task = ConditionalFlowMatchingModule(net=net, solver=instantiate(cfg.model.solver))
    src = tile_batch(batch, tile)
    before = evals[0]
    t2 = time.perf_counter()
    x1 = dopri_task.generate(src, num_steps=100)
    torch.cuda.synchronize()
    dopri_s = time.perf_counter() - t2
    dopri_evals = evals[0] - before
    launches, total_evals = fused_attention.launches, evals[0]
    # ---- end of the main path ---------------------------------------------
    if not torch.isfinite(x1).all() or x1.shape != src.shape:
        raise AssertionError("dopri5 generate returned a non-finite or misshapen batch")
    log(f"dopri5: {dopri_evals} velocity evaluations on a batch of {batch} tiles in {dopri_s:.3f} s")
    if launches == 0 or launches != total_evals:
        raise AssertionError(f"K1 launches {launches} != velocity evaluations {total_evals}")
    tiles = sum(r["tiles"] for r in requests)
    seconds = sum(r["latency_s"] for r in requests)
    summary = dict(
        card=card, n_params=n_params, warmup_s=warm_s, requests=len(requests), tiles=tiles,
        tiles_per_s=tiles / seconds, latency_s=[r["latency_s"] for r in requests],
        velocity_evals=total_evals, k1_launches=launches, dopri5_evals=dopri_evals,
        dopri5_s=dopri_s, requests_served=info["requests_served"],
    )
    log("slice " + json.dumps(summary))
    if min(r["mean_abs_change"] for r in requests) < 1.0:
        raise AssertionError("the translated images equal their inputs: the velocity is zero")
    return summary, net


def phase_unet_parity(net) -> dict:
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = compose(REPO / "configs", "infer.yaml", ["model=conditional_flow_matching"])
    cpu_net = instantiate(cfg.model.net, device="cpu").eval()
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    net.eval()
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32))
    t = torch.tensor([0.37])
    before = fused_attention.launches
    with torch.inference_mode():
        got = net(t.cuda(), x.cuda()).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = cpu_net(t, x)
        cpu_s = time.perf_counter() - t0
    if fused_attention.launches != before + 1:
        raise AssertionError("the card forward did not go through K1")
    err = (got - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    row = dict(max_abs_err=err, ref_max_abs=ref.abs().max().item(), tol=UNET_REL_TOL * scale,
               cpu_forward_s=cpu_s, ok=err <= UNET_REL_TOL * scale)
    log("unet-parity " + json.dumps(row))
    if not row["ok"] or not torch.isfinite(got).all():
        raise AssertionError(f"f32 UNet on the card disagrees with the CPU plain path: {row}")
    return row


def step_clock():
    """A training callback (instantiated from the config by ``_target_``) that
    records the device-synchronized end time and loss of every optimizer step,
    and counts the net's forward calls (a multitask net's encoder passes)
    through a hook installed at fit start."""
    import torch

    from stain2stain_tpu_torch.training import Callback

    class StepClock(Callback):
        def __init__(self):
            self.ends, self.losses, self.forwards, self.t0 = [], [], [0], None

        def on_fit_start(self, trainer, task):
            net = getattr(task.net, "encoder", task.net)  # a multitask net: its encoder's passes
            net.register_forward_hook(lambda *_: self.forwards.__setitem__(0, self.forwards[0] + 1))

        def on_train_epoch_start(self, trainer, task):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, trainer, task, metrics):
            self.losses.append(float(metrics["loss"]))  # synchronizes
            self.ends.append(time.perf_counter())

    return StepClock()


TRAIN_OVERRIDES = [
    "experiment=quality_synthetic_256",
    "trainer.accelerator=gpu",
    "data.n_train=256",
    "data.n_val=32",
    "data.n_test=32",
    "trainer.max_epochs=1",
    "trainer.check_val_every_n_epoch=1",
    "test=true",
]
# f32 training at the reference's he2ihc_CF_new_data operating point (512 px,
# batch 6 a device, trainer.precision 32, the trainer's default): synthetic
# pairs in place of its CSV tiles, 48 of them for 8 steps
TRAIN_F32_OVERRIDES = [
    "experiment=quality_synthetic_256",
    "trainer.accelerator=gpu",
    "trainer.precision=32",
    "data.tile_size=512",
    "data.image_size=512",
    "data.batch_size=6",
    "data.n_train=48",
    "data.n_val=12",
    "data.n_test=12",
    "trainer.max_epochs=1",
    "trainer.check_val_every_n_epoch=1",
    "test=true",
]
# the DiT at DiT-XL/2's widths with depth cut to 4 blocks (the K1 shape of each
# block is the published one: 16 heads of 72 over T 1024), bf16-mixed as
# quality_synthetic_256 sets, on phase 8's 512-px data: 8 steps of 6
TRAIN_DIT_OVERRIDES = [o for o in TRAIN_F32_OVERRIDES if o != "trainer.precision=32"] + [
    "model.net={_target_: stain2stain_tpu_torch.models.dit.DiT, dim: [3, 512, 512], patch_size: 16, "
    "hidden_size: 1152, depth: 4, num_heads: 16, mlp_ratio: 4.0}",
]
# level remat: every ResBlock and the mid block (with its attention) lie in a
# region, so K1-fwd and each fused block's K2 run again in every backward
REMAT_OVERRIDE = "+model.net.use_checkpoint=level"
# the reference's any<->any study (configs/experiment/any2any_he_amyloid.yaml:
# f32, 256 px) on synthetic domain folders; its global batch of 128, which the
# reference split over several GPUs, is cut to 32 for one card
ANY2ANY_OVERRIDES = [
    "experiment=any2any_he_amyloid",
    "trainer.accelerator=gpu",
    "data.class_folder_mapping={0: HE, 1: IHC, 2: Grayscale}",
    "data.batch_size=32",
    "trainer.min_epochs=1",
    "trainer.max_epochs=1",
    "test=true",
    REMAT_OVERRIDE,
]
ANY2ANY_TILES = 320  # val_split 0.2: 256 training tiles (8 steps of 32), 64 val tiles
# the reference's mask studies (configs/experiment/he2ihc_masked_*.yaml,
# he2ihc_pos_neg_amyloid.yaml: f32, 512 px, batch 8 a device) on one card
# (their 4-device DDP cut to trainer.devices=1; they only fill in
# logger.wandb fields, which the default logger group leaves without a
# _target_, so the csv logger runs: phase 22 drives the W&B logger) and on
# synthetic tiles through the
# experiments' own CSV datamodules; one epoch, so the best checkpoint is
# taken every epoch (the experiments take it every 10 of 50)
MASK_COMMON = ["trainer.accelerator=gpu", "trainer.devices=1", "trainer.min_epochs=1", "trainer.max_epochs=1",
               "test=true", "data.csv_file_name=metadata.csv", "callbacks.model_checkpoint.every_n_epochs=1"]
# train / val / test 512-px tiles of the masked tree: 8 steps of 8 for the
# mask-conditioned path (its first 8 batches), 8 steps of 16 for train-multitask
MASK_TILES = (128, 16, 16)
POS_NEG_TILES = dict(n_pos_train=24, n_neg=8, n_val=8, n_test=8)  # 32 draws: 4 steps of 8
# the three plain-net mask studies at a cut depth: 4 steps, one val and one test batch
SHORT = ["trainer.limit_train_batches=4", "trainer.limit_val_batches=1", "trainer.limit_test_batches=1"]
# the reference's multitask studies on one card (configs/experiment/multitask_he2ihc_amyloid.yaml: f32, 512 px,
# batch 32 a device; gray_matter/multitask_he2ihc_gray_matter.yaml: f32, 256 px, batch 32, 2 classes), with the
# mask studies' cuts (4-device DDP to trainer.devices=1, the csv logger, one epoch with its best checkpoint), under
# the reference's BatchNorm (the configs' default is GroupNorm, which phase 21 drives); the binary study's batch
# 32 cut to 16 for one card (its encoder runs on 2B images)
BATCH_NORM = ["+model.encoder.norm=batch", "+model.flow_decoder.norm=batch", "+model.seg_decoder.norm=batch"]
MULTITASK_BATCH = 16
MULTICLASS_TILES = (256, 32, 32)  # train / val / test 256-px tiles with 2-class masks: 8 steps of 32
# phase 7's flagship operating point under the reference's default logger (W&B: its JSONL and the checkpoint
# mirrored into $WANDB_CACHE_DIR without the client), cut to 4 steps; then resumed from the logged model for
# 4 more under the profiler
WANDB_RUN = "chip-smoke"
WANDB_OVERRIDES = TRAIN_OVERRIDES + ["logger=wandb", f"logger.wandb.name={WANDB_RUN}", "trainer.limit_train_batches=4"]
WANDB_REF = f"stain2stain/model-{WANDB_RUN}:latest"
# the flagship quality recipe (configs/experiment/quality_real_256.yaml: bf16-mixed, 256 px, batch 32, the plain CSV
# datamodule over the on-disk tile tree, its device cache) cut to one epoch of its 512 tiles, validated and tested
QUALITY_REAL_OVERRIDES = ["experiment=quality_real_256", "trainer.accelerator=gpu", "trainer.max_epochs=1",
                          "trainer.check_val_every_n_epoch=1", "test=true"]
# each training path: its overrides (``<data>`` stands for its data folder) and the folder of its synthetic data
TRAIN_PATHS = {
    "train": (TRAIN_OVERRIDES, "data"),
    "train-fused": (TRAIN_OVERRIDES + [FUSED_OVERRIDE], "data"),
    "train-f32": (TRAIN_F32_OVERRIDES, "data-512"),
    "train-dit": (TRAIN_DIT_OVERRIDES, "data-512"),
    "train-remat": (TRAIN_F32_OVERRIDES + [REMAT_OVERRIDE], "data-512"),
    "train-fused-remat": (TRAIN_OVERRIDES + [FUSED_OVERRIDE, REMAT_OVERRIDE], "data"),
    "train-any2any": (ANY2ANY_OVERRIDES, "domains"),
    "train-masked-conditioned": (["experiment=he2ihc_masked_conditioned", "trainer.limit_train_batches=8"]
                                 + MASK_COMMON, "data-mask"),
    "train-masked": (["experiment=he2ihc_masked_amyloid"] + MASK_COMMON + SHORT, "data-mask"),
    "train-roi": (["experiment=he2ihc_masked_amyloid_ROI"] + MASK_COMMON + SHORT, "data-mask"),
    "train-pos-neg": (["experiment=he2ihc_pos_neg_amyloid", "data.negative_data_dir=<data>"]
                      + MASK_COMMON[:-1] + SHORT, "data-pos-neg"),
    "train-multitask": (["experiment=multitask_he2ihc_amyloid", f"batch_size={MULTITASK_BATCH}"] + MASK_COMMON
                        + BATCH_NORM, "data-mask"),
    "train-multitask-multiclass": (["experiment=gray_matter/multitask_he2ihc_gray_matter",
                                    "data.target_column=ihc_filepath"] + MASK_COMMON + BATCH_NORM, "data-multiclass"),
    "train-wandb": (WANDB_OVERRIDES, "data"),
    "train-resume": (WANDB_OVERRIDES + [f"ckpt_path=wandb-artifact://{WANDB_REF}", "trainer.max_epochs=2",
                                        "+trainer.profiler=advanced"], "data"),
    "train-s2b": (TRAIN_F32_OVERRIDES + ["+model.net.s2b_conv=2"], "data-512"),
    "train-quality-real": (QUALITY_REAL_OVERRIDES, "quality-tiles"),
}
MULTITASK_PATHS = ("train-multitask", "train-multitask-multiclass")  # the shared-encoder nets: no attention
F32_PATHS = ("train-f32", "train-remat", "train-s2b", "train-any2any", "train-masked-conditioned", "train-masked", "train-roi",
             "train-pos-neg") + MULTITASK_PATHS
PATH_STEPS = {"train-masked": 4, "train-roi": 4, "train-pos-neg": 4, "train-wandb": 4, "train-resume": 4,
              "train-quality-real": 16}  # 8 otherwise


def phase_train(card: str, work: Path, name: str = "train", callbacks: Optional[dict] = None) -> tuple[dict, dict]:
    """A training path of ``TRAIN_PATHS`` at full width through
    ``stain2stain_tpu_torch.train``: ``train`` (bf16-mixed, 256 px, batch 32),
    ``train-fused`` (the same with ``+model.net.fused_conv=true``: the
    ResBlocks through K2–K5), ``train-f32`` (f32, 512 px, batch 6),
    ``train-remat`` and ``train-fused-remat`` (``train-f32`` and
    ``train-fused`` with ``use_checkpoint=level``), ``train-dit`` (the DiT,
    bf16-mixed, 512 px, batch 6, 4 blocks), ``train-any2any`` (the
    any2any experiment, f32, 256 px, batch 32, level remat; its domain
    folders made by the caller), and the mask studies at f32, 512 px, batch
    8 on trees the caller makes: ``train-masked-conditioned`` (the toggled
    4→3 net, attention at level 3 and in the mid block: six K1 a forward),
    ``train-masked``, ``train-roi`` and ``train-pos-neg`` (the plain net,
    4 steps), and the multitask studies under BatchNorm:
    ``train-multitask`` (f32, 512 px, batch 16, binary) and
    ``train-multitask-multiclass`` (f32, 256 px, batch 32, 2 classes), and
    ``train-wandb`` and ``train-resume`` (``train`` under the W&B logger, 4
    steps, then 4 more from its logged model under the profiler). The
    synthetic data under ``work`` of the first paths is made once per folder
    and reused. ``callbacks``: more callback configs, ahead of the step
    clock. K1-fwd must launch once per attention layer of each net
    forward (and of each recompute under level remat), K1-bwd once per
    attention layer a step: on the multitask nets, which have none, never.
    Returns (summary, the objects ``train`` built)."""
    import torch

    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.models.dit import Attention as DiTAttention
    from stain2stain_tpu_torch.models.unet import AttentionBlock
    from stain2stain_tpu_torch.ops.dropout import FastDropout
    from stain2stain_tpu_torch.train import train

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for training:
    torch.backends.cudnn.allow_tf32 = True  # f32 matmul, TF32 cuDNN convs
    fused = FUSED_OVERRIDE in TRAIN_PATHS[name][0]
    remat = REMAT_OVERRIDE in TRAIN_PATHS[name][0]
    path_overrides, data = TRAIN_PATHS[name]
    overrides = [o.replace("<data>", str(work / data)) for o in path_overrides] + [f"data.data_dir={work / data}"]
    cfg = compose(REPO / "configs", "train.yaml", overrides)
    cfg["runtime"] = {"output_dir": str(work / f"out-{name}"), "cwd": str(work)}
    cfg["extras"]["print_config"] = False
    log(f"{name}: " + " ".join(overrides))

    for key, callback in (callbacks or {}).items():
        cfg["callbacks"][key] = callback
    cfg["callbacks"]["step_clock"] = {"_target_": f"{__name__}.step_clock"}  # as a script or imported
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts zeroed just before, read just after --------
    zero_kernel_launches()
    t0 = time.perf_counter()
    metrics, objects = train(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernel_launches()
    # ---- end of the main path -----------------------------------------------
    fwd_launches, bwd_launches = launches["K1-fwd"], launches["K1-bwd"]
    k2, k3, k4, k5 = (launches[k] for k in ("K2", "K3", "K4", "K5"))
    clock = objects["callbacks"][-1]
    trainer = objects["trainer"]
    task = objects["model"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    peak_reserved_gib = torch.cuda.max_memory_reserved() / 2**30
    steps = len(clock.losses)
    want_steps = PATH_STEPS.get(name, 8)
    # attention layers a forward: the flagship's mid block, or level 3 and the mid block, or each DiT block
    attention = sum(isinstance(m, (AttentionBlock, DiTAttention)) for m in task.net.modules())
    dropout_layers = sum(isinstance(m, FastDropout) and m.impl == "hash" and 0 < m.rate < 1 for m in task.net.modules())
    durations = [b - a for a, b in zip([clock.t0] + clock.ends[:-1], clock.ends)]
    steady = durations[2:8] if steps >= 8 else durations[1:]  # steps 3-8, or 2-4 on the 4-step paths
    step_ms = statistics.median(steady) * 1e3 if steady else float("nan")
    batch = int(cfg["data"]["batch_size"])
    ckpt = trainer.checkpoint_callback
    summary = dict(
        card=card, steps=steps, global_step=trainer.global_step, batch=batch,
        step_ms_median_3_8=step_ms, step_ms=[d * 1e3 for d in durations], tiles_per_s=batch / (step_ms / 1e3),
        peak_mem_gib=peak_gib, peak_reserved_gib=peak_reserved_gib, wall_s=wall_s, losses=clock.losses, forwards=clock.forwards[0],
        k1_fwd_launches=fwd_launches, k1_bwd_launches=bwd_launches,
        k2_launches=k2, k3_launches=k3, k4_launches=k4, k5_launches=k5, dropout_launches=launches["dropout"],
        dropout_layers=dropout_layers, ln_modulate_fwd_launches=launches["ln_modulate_fwd"],
        ln_modulate_bwd_launches=launches["ln_modulate_bwd"],
        val_loss=metrics.get("val/loss"), test_loss=metrics.get("test/loss"),
        best=Path(ckpt.best_model_path).name if ckpt and ckpt.best_model_path else None,
        best_path=ckpt.best_model_path if ckpt else None,
        n_params=sum(p.numel() for p in task.net.parameters()),
        dtype=str(task.net.dtype), attention_layers=attention, task=type(task).__name__,
        datamodule=type(objects["datamodule"]).__name__,
        metrics={k: v for k, v in metrics.items() if k.split("/")[0] in ("train", "val", "test")},
    )
    if hasattr(task, "coins"):
        summary["toggle_coins"] = dict(task.coins)
    if name == "train-pos-neg":  # the negatives the weighted sampler drew for the steps that ran
        dm = objects["datamodule"]
        loader = dm.train_dataloader()
        loader.set_epoch(0)
        drawn = [int(i) for b in loader._local_batches()[:steps] for i in b]
        n_pos = len(dm.data_train.datasets[0])
        summary["negatives_drawn"] = sum(i >= n_pos for i in drawn)
        summary["examples_drawn"] = len(drawn)
    log(f"{name} " + json.dumps(summary))
    finite = all(math.isfinite(x) for x in clock.losses + [summary["val_loss"] or math.nan, summary["test_loss"] or math.nan])
    if steps != want_steps or not finite:
        raise AssertionError(f"training did not run {want_steps} finite steps with finite val/test losses: {summary}")
    if not summary["best"] or not (Path(ckpt.last_model_path) / "state.pt").is_file():
        raise AssertionError("training wrote no best or last checkpoint")
    if (attention == 0) != (name in MULTITASK_PATHS) or bwd_launches != attention * steps:
        raise AssertionError(f"K1-bwd launches {bwd_launches} != {attention} attention layers x {steps} backward passes "
                             "(the UNet paths have attention layers, the multitask nets none)")
    if name == "train-dit" and attention != 4:
        raise AssertionError(f"the DiT path's net has {attention} attention layers, not its 4 blocks")
    # the LayerNorm-modulate pair: two a DiT block and the final layer's, each net forward and each step
    ln_calls = 2 * attention + 1 if name == "train-dit" else 0
    ln_launches = (summary["ln_modulate_fwd_launches"], summary["ln_modulate_bwd_launches"])
    if ln_launches != (ln_calls * clock.forwards[0], ln_calls * steps):
        raise AssertionError(f"{name}: the LayerNorm-modulate kernels launched {ln_launches} times, not "
                             f"({ln_calls} x {clock.forwards[0]} forwards, {ln_calls} x {steps} steps)")
    if (name in F32_PATHS) != (summary["dtype"] == "torch.float32"):
        raise AssertionError(f"{name} computed in {summary['dtype']}")
    # level remat recomputes every region in each backward pass: each
    # attention layer's K1-fwd and every fused ResBlock's K2 once more a step
    recomputes = steps if remat else 0
    if clock.forwards[0] == 0 or fwd_launches != attention * (clock.forwards[0] + recomputes):
        raise AssertionError(
            f"K1-fwd launches {fwd_launches} != {attention} attention layers x (net forward calls "
            f"{clock.forwards[0]} + recomputes {recomputes})"
        )
    if name == "train-masked-conditioned" and (attention != 6 or summary["toggle_coins"]["drawn"] != steps):
        raise AssertionError(f"the mask-conditioned net has {attention} attention layers (6 expected) or drew "
                             f"{summary['toggle_coins']} toggle coins in {steps} steps")
    if name == "train-roi" and not all(f"{p}/{k}" in metrics for p in ("train", "val", "test")
                                       for k in ("flow_loss", "roi_charbonnier")):
        raise AssertionError(f"the ROI path logged no flow_loss or roi_charbonnier: {sorted(metrics)}")
    if name == "train-pos-neg" and not 0 < summary["negatives_drawn"] < summary["examples_drawn"]:
        raise AssertionError(f"the pos/neg path drew {summary['negatives_drawn']} negatives")
    if name in MULTITASK_PATHS:
        check_multitask_run(name, summary, metrics, ckpt)
    want_fwd = FLAGSHIP_FUSED_CONVS * (clock.forwards[0] + recomputes) if fused else 0
    want_bwd = FLAGSHIP_FUSED_CONVS * steps if fused else 0
    if k2 != want_fwd or (k3, k4, k5) != (want_bwd,) * 3 or (fused and k2 == 0):
        raise AssertionError(
            f"K2-K5 launches {(k2, k3, k4, k5)} != ({want_fwd}, {want_bwd}, {want_bwd}, {want_bwd}): "
            f"{FLAGSHIP_FUSED_CONVS} per net forward (and per recompute under level remat) and per backward "
            "pass with fused_conv, none without"
        )
    # the hash dropout kernel: once a forward and once a backward for each active
    # layer of the unfused net, and once more a recompute under level remat;
    # never with fused_conv, where every ResBlock drops inside K2
    want_dropout = 0 if fused else dropout_layers * (2 * steps + recomputes)
    if summary["dropout_launches"] != want_dropout:
        raise AssertionError(
            f"{name}: the hash dropout kernel launched {summary['dropout_launches']} times, not {want_dropout}: "
            f"{dropout_layers} layers x (2 x {steps} steps + {recomputes} recomputes) without fused_conv, none with it"
        )
    if name == "train-fused":
        # the fused run's weights through the unfused net: the same val loss, since
        # both paths compute one function (a different loss than the unfused run's
        # comes from the weights training reached, not from the path)
        from stain2stain_tpu_torch.config import instantiate

        task = objects["model"]
        unfused = instantiate(compose(REPO / "configs", "train.yaml", TRAIN_OVERRIDES).model.net, device="cuda")
        unfused.load_state_dict(task.net.state_dict())
        unfused.dtype = task.net.dtype
        fused_net, task.net = task.net, unfused
        cross = trainer._run_eval(objects["datamodule"].val_dataloader(), "val")["val/loss"]
        task.net = fused_net
        summary["val_loss_same_weights_unfused_path"] = cross
        log(f"{name}-cross-eval " + json.dumps({"val_loss": summary["val_loss"], "unfused_path": cross}))
        if abs(cross - summary["val_loss"]) > 1e-2 * summary["val_loss"]:
            raise AssertionError(f"the fused run's weights give another val loss through the unfused net: {cross}")
    return summary, objects


def check_multitask_run(name: str, summary: dict, metrics: dict, ckpt) -> None:
    """A multitask path logged its segmentation terms (per-class Dice and IoU
    in eval), ran one encoder pass a train step, and its best checkpoint holds
    every BatchNorm's running statistics, updated once a step."""
    import torch

    other = "seg_ce" if name == "train-multitask-multiclass" else "seg_bce"
    want = [f"train/{k}" for k in ("flow_loss", "seg_loss", "seg_dice", other)]
    want += [f"{p}/{k}" for p in ("val", "test") for k in ("flow_loss", "seg_loss", "dice_coef", "iou")]
    missing = [k for k in want if not math.isfinite(metrics.get(k, math.nan))]
    saved = torch.load(Path(ckpt.best_model_path) / "state.pt", map_location="cpu", weights_only=True)["model"]
    tracked = {int(v) for k, v in saved.items() if k.endswith("num_batches_tracked")}
    n_norms = sum(k.endswith("running_var") for k in saved)
    summary.update(n_batch_norms=n_norms, batch_norm_updates=sorted(tracked),
                   seg_metrics={k: metrics[k] for k in want if k in metrics})
    log(f"{name}-seg " + json.dumps({k: summary[k] for k in ("n_batch_norms", "batch_norm_updates", "seg_metrics")}))
    if missing or n_norms == 0 or tracked != {summary["steps"]}:
        raise AssertionError(f"{name}: no finite {missing}, or the checkpoint's BatchNorms ({n_norms}, updated "
                             f"{sorted(tracked)} times) do not match {summary['steps']} steps")


def phase_fused_grad_parity() -> dict:
    """One bf16 train step of the fused flagship, card (K2–K5) vs CPU (plain versions)."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops import conv
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule

    cfg = compose(REPO / "configs", "train.yaml", [FUSED_OVERRIDE, "model.net.dropout=0.1"])
    torch.manual_seed(0)
    nets = {dev: instantiate(cfg.model.net, device=dev) for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():  # jitter every parameter: ADM zero-inits the output convs
        for p in nets["cpu"].parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    rng = np.random.default_rng(6)
    batch = tuple(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8) for _ in range(2))
    t = torch.tensor([0.3, 0.8])
    out = {}
    for dev, net in nets.items():
        net.dtype = torch.bfloat16  # what bf16-mixed sets
        task = ConditionalFlowMatchingModule(net=net, device=dev)
        prepared = task.prepare_batch(batch, train=False)
        before = [kernel.launches for kernel in conv.KERNELS]
        t0 = time.perf_counter()
        # a CPU generator on both sides: the same noise and the same dropout seeds
        loss, _ = task.loss_and_metrics(prepared, torch.Generator().manual_seed(7), train=True, t=t)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = [kernel.launches - b for kernel, b in zip(conv.KERNELS, before)]
        out[dev] = (loss.item(), {n: p.grad.detach().float().cpu() for n, p in net.named_parameters()},
                    time.perf_counter() - t0, launches)
    (loss_gpu, g_gpu, gpu_s, launches), (loss_cpu, g_cpu, cpu_s, _) = out["cuda"], out["cpu"]
    ref_max = max(g.abs().max().item() for g in g_cpu.values())
    err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    worst = max(g_cpu, key=lambda n: (g_gpu[n] - g_cpu[n]).abs().max().item())
    row = dict(loss_card=loss_gpu, loss_cpu=loss_cpu, max_abs_grad_err=err, worst_param=worst,
               ref_max_abs_grad=ref_max, tol=FUSED_GRAD_REL_TOL * ref_max, card_step_s=gpu_s, cpu_step_s=cpu_s,
               k2_k5_launches=launches)
    # the same weights through the unfused net on the card, eval mode: one function
    unfused = instantiate(compose(REPO / "configs", "train.yaml", ["model.net.dropout=0.1"]).model.net, device="cuda")
    unfused.load_state_dict(nets["cuda"].state_dict())
    unfused.dtype = torch.bfloat16
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        fused_out = nets["cuda"].eval()(t.cuda(), x).float()
        unfused_out = unfused.eval()(t.cuda(), x).float()
    row["eval_fused_vs_unfused_max_abs"] = (fused_out - unfused_out).abs().max().item()
    row["eval_unfused_max_abs"] = unfused_out.abs().max().item()
    row["eval_tol"] = FUSED_EVAL_REL_TOL * row["eval_unfused_max_abs"]
    row["ok"] = (err <= row["tol"] and abs(loss_gpu - loss_cpu) <= 1e-2 * abs(loss_cpu)
                 and launches == [FLAGSHIP_FUSED_CONVS] * 4
                 and row["eval_fused_vs_unfused_max_abs"] <= row["eval_tol"]
                 and all(torch.isfinite(g).all() for g in g_gpu.values()))
    log("fused-grad-parity " + json.dumps(row))
    if not row["ok"]:
        raise AssertionError(f"fused bf16 flagship on the card disagrees with the CPU or the unfused net: {row}")
    return row


def phase_grad_parity() -> dict:
    """One f32 train step of the flagship on the card vs the CPU plain path."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention_backward
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("grad-parity: TF32 off for matmul and cuDNN")
    cfg = compose(REPO / "configs", "train.yaml", ["model.net.dropout=0.0"])
    torch.manual_seed(0)
    nets = {dev: instantiate(cfg.model.net, device=dev) for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():  # jitter every parameter: ADM zero-inits the output convs
        for p in nets["cpu"].parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    rng = np.random.default_rng(4)
    batch = tuple(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8) for _ in range(2))
    t = torch.tensor([0.3, 0.8])
    out = {}
    for dev, net in nets.items():
        task = ConditionalFlowMatchingModule(net=net, device=dev)
        prepared = task.prepare_batch(batch, train=False)
        t0 = time.perf_counter()
        loss, _ = task.loss_and_metrics(prepared, train=True, t=t)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (loss.item(), {n: p.grad.detach().cpu() for n, p in net.named_parameters()},
                    time.perf_counter() - t0)
    (loss_gpu, g_gpu, gpu_s), (loss_cpu, g_cpu, cpu_s) = out["cuda"], out["cpu"]
    ref_max = max(g.abs().max().item() for g in g_cpu.values())
    err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    worst = max(g_cpu, key=lambda n: (g_gpu[n] - g_cpu[n]).abs().max().item())
    row = dict(loss_card=loss_gpu, loss_cpu=loss_cpu, max_abs_grad_err=err, worst_param=worst,
               ref_max_abs_grad=ref_max, tol=GRAD_REL_TOL * ref_max, card_step_s=gpu_s, cpu_step_s=cpu_s,
               k1_bwd_launches=fused_attention_backward.launches)
    row["ok"] = (err <= row["tol"] and abs(loss_gpu - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu))
                 and all(torch.isfinite(g).all() for g in g_gpu.values()))
    log("grad-parity " + json.dumps(row))
    if not row["ok"]:
        raise AssertionError(f"f32 flagship gradients on the card disagree with the CPU plain path: {row}")
    return row


REMAT_MODES = [False, "block", "level", "block:2", "level:2"]
REMAT_STEPS = 4  # timed steps a mode, after one warm-up step
# remat against no remat on the card, f32, TF32 off, deterministic cuDNN: the
# recompute runs the same kernels on the same inputs, so bit for bit expected
REMAT_REL_TOL = 1e-6


def phase_remat_modes(card: str) -> list:
    """Each ``use_checkpoint`` mode of ``REMAT_MODES`` at phase 8's operating
    point (the flagship, f32, 512 px, batch 6), through the trainer's own
    step: peak device memory (reset after a warm-up step, so it holds the
    parameters, gradients, Adam state and one step's activations), the median
    step time, K1-fwd / K1-bwd launches a step, and the device memory one
    training forward leaves for its backward. K1-fwd launches twice a
    step where the mid block is rematted (``block``, ``level``), once
    otherwise; K1-bwd once."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention, fused_attention_backward
    from stain2stain_tpu_torch.training import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for training
    torch.backends.cudnn.allow_tf32 = True
    cfg = compose(REPO / "configs", "train.yaml", TRAIN_F32_OVERRIDES)
    rng = np.random.default_rng(0)
    batch = tuple(torch.from_numpy(rng.integers(0, 256, (6, 512, 512, 3), dtype=np.uint8)).cuda() for _ in range(2))
    augment = {"crop_size": 512, "hflip": True, "vflip": True}
    rows = []
    for mode in REMAT_MODES:
        torch.manual_seed(0)
        net = instantiate(cfg.model.net, device="cuda", use_checkpoint=mode)
        task = instantiate(cfg.model, net=net, device="cuda")
        trainer = Trainer(accelerator="gpu", precision=32, logger=False)
        trainer._prepare_task(task)
        trainer._init_state(task)
        trainer._train_step(task, batch, augment)  # Adam state made, cuDNN algorithms chosen
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_attention.launches = 0
        fused_attention_backward.launches = 0
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            trainer._train_step(task, batch, augment)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        k1_fwd, k1_bwd = fused_attention.launches / REMAT_STEPS, fused_attention_backward.launches / REMAT_STEPS
        # what the forward leaves for the backward: device memory held after one
        # training forward (the loss kept), beyond what was held before it
        before = torch.cuda.memory_allocated()
        prepared = task.prepare_batch(batch, torch.Generator().manual_seed(1), train=True, augment=augment)
        loss, _ = task.loss_and_metrics(prepared, torch.Generator().manual_seed(1), train=True)
        torch.cuda.synchronize()
        held = (torch.cuda.memory_allocated() - before) / 2**30
        loss.backward()
        trainer.state.optimizer.zero_grad(set_to_none=True)
        del prepared, loss
        row = dict(card=card, mode=str(mode), batch=6, px=512, peak_mem_gib=peak, held_after_forward_gib=held,
                   step_ms=statistics.median(times) * 1e3, step_ms_all=[t * 1e3 for t in times],
                   k1_fwd_per_step=k1_fwd, k1_bwd_per_step=k1_bwd)
        log("remat-mode " + json.dumps(row))
        rows.append(row)
        del net, task, trainer
        gc.collect()
        torch.cuda.empty_cache()
    stored = rows[0]["peak_mem_gib"]
    for row in rows:
        want_fwd = 2 if row["mode"] in ("block", "level") else 1
        if (row["k1_fwd_per_step"], row["k1_bwd_per_step"]) != (want_fwd, 1):
            raise AssertionError(f"remat mode {row['mode']}: K1 launches a step {row} (want {want_fwd} and 1)")
        if row["mode"] != "False" and row["peak_mem_gib"] >= stored:
            raise AssertionError(f"remat mode {row['mode']} peaks at {row['peak_mem_gib']} GiB, no less than {stored}")
    return rows


def phase_remat_parity() -> dict:
    """One f32 step of the flagship at 512 px, batch 2 (TF32 off,
    deterministic cuDNN, dropout 0.1, one generator seed) under each mode of
    ``REMAT_MODES`` against the step without remat: the loss and every
    gradient within ``REMAT_REL_TOL`` × max|g|, and the generator left in the
    same state (the dropout seeds are drawn once, before the regions)."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cfg = compose(REPO / "configs", "train.yaml", TRAIN_F32_OVERRIDES + ["model.net.dropout=0.1"])
    torch.manual_seed(0)
    state = instantiate(cfg.model.net, device="cuda").state_dict()
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():  # jitter every parameter: ADM zero-inits the output convs
        for v in state.values():
            v.add_(0.02 * torch.randn(v.shape, device="cuda", generator=gen))
    rng = np.random.default_rng(4)
    batch = tuple(rng.integers(0, 256, size=(2, 512, 512, 3), dtype=np.uint8) for _ in range(2))
    t = torch.tensor([0.3, 0.8])
    out = {}
    try:
        for mode in REMAT_MODES:
            net = instantiate(cfg.model.net, device="cuda", use_checkpoint=mode)
            net.load_state_dict(state)
            task = ConditionalFlowMatchingModule(net=net, device="cuda")
            prepared = task.prepare_batch(batch, train=False)
            seeds = torch.Generator().manual_seed(7)
            before = fused_attention.launches
            loss, _ = task.loss_and_metrics(prepared, seeds, train=True, t=t)
            loss.backward()
            torch.cuda.synchronize()
            out[str(mode)] = (loss.item(), {n: p.grad.detach() for n, p in net.named_parameters()},
                              seeds.get_state(), fused_attention.launches - before)
            del net, task, prepared, loss
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref_loss, ref_grads, ref_state, _ = out["False"]
    g_max = max(g.abs().max().item() for g in ref_grads.values())
    rows = {}
    for mode, (loss, grads, gen_state, k1) in out.items():
        err = max((grads[n] - g).abs().max().item() for n, g in ref_grads.items())
        rows[mode] = dict(loss=loss, loss_equal=loss == ref_loss, max_abs_grad_err=err, ref_max_abs_grad=g_max,
                          bit_for_bit=loss == ref_loss and err == 0.0,
                          generator_state_equal=bool(torch.equal(gen_state, ref_state)), k1_fwd_launches=k1)
    ok = all(abs(r["loss"] - ref_loss) <= REMAT_REL_TOL * abs(ref_loss) and r["max_abs_grad_err"] <= REMAT_REL_TOL * g_max
             and r["generator_state_equal"] for r in rows.values())
    result = dict(ok=ok, tol_rel=REMAT_REL_TOL, modes=rows)
    log("remat-parity " + json.dumps(result))
    del out
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"a remat mode's step differs from the stored step on the card: {result}")
    return result


GENERATE_ALL_REL_TOL = 1e-4  # one batched integration against three, TF32 off: summation order only


def phase_serve_any2any(card: str, task) -> dict:
    """The any2any task trained in ``train-any2any``, its weights jittered (std
    0.02, as phase 5), behind the class-conditioned ``TranslationServer``
    over HTTP: one PNG request for each class 0, 1, 2; the three outputs must
    differ and K1-fwd must launch once per velocity evaluation. Then
    ``generate_all_classes`` on 16 tiles (K1-fwd at BH 768) against
    ``generate`` per class, TF32 off."""
    import numpy as np
    import torch
    from PIL import Image

    from stain2stain_tpu_torch.ops.attention import fused_attention
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.server import TranslationServer, serve_forever
    from stain2stain_tpu_torch.tasks import ClassConditionalFlowMatchingModule
    from stain2stain_tpu_torch.wsi import tile_starts

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for serving
    torch.backends.cudnn.allow_tf32 = True
    net = task.net
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.02 * torch.randn(p.shape, device=p.device, generator=gen))
    evals = [0]
    hook = net.register_forward_hook(lambda *_: evals.__setitem__(0, evals[0] + 1))
    task = ClassConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler"), num_classes=net.num_classes)
    # ---- the main path: counts zeroed just before, read just after --------
    fused_attention.launches = 0
    evals[0] = 0
    t0 = time.perf_counter()
    server = TranslationServer(task, num_steps=2, tile=256, overlap=32, batch=16)
    warm_s = time.perf_counter() - t0
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(server, "127.0.0.1", 0, ready), daemon=True)
    thread.start()
    img = _test_image(700, 520, seed=21)
    n_tiles = len(tile_starts(700, 256, 224)) * len(tile_starts(520, 256, 224))
    outs, requests = {}, []
    try:
        if not ready.wait(30):
            raise RuntimeError("server did not bind")
        base = f"http://127.0.0.1:{server.bound_port}"
        for cls in (0, 1, 2):
            req = urllib.request.Request(f"{base}/translate?target_class={cls}", data=_png(img),
                                         headers={"Content-Type": "image/png"})
            t1 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, payload = resp.status, resp.read()
            latency = time.perf_counter() - t1
            outs[cls] = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB")).astype(np.float32)
            if status != 200 or outs[cls].shape != img.shape:
                raise AssertionError(f"bad response {status} {outs[cls].shape} for class {cls}")
            requests.append(dict(target_class=cls, latency_s=latency, tiles=n_tiles,
                                 mean_abs_change=float(np.abs(outs[cls] - img).mean())))
            log("any2any-request " + json.dumps(requests[-1]))
        info = json.loads(urllib.request.urlopen(f"{base}/info", timeout=60).read())
    finally:
        if server.httpd is not None:
            server.httpd.shutdown()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    launches, total_evals = fused_attention.launches, evals[0]
    # ---- end of the main path ---------------------------------------------
    diffs = {f"{a}-{b}": float(np.abs(outs[a] - outs[b]).mean()) for a, b in ((0, 1), (0, 2), (1, 2))}
    if launches == 0 or launches != total_evals:
        raise AssertionError(f"K1 launches {launches} != velocity evaluations {total_evals}")
    if min(diffs.values()) < 0.5 or not info["class_conditioned"]:
        raise AssertionError(f"the classes translate alike (mean abs grey-level differences {diffs}) or {info}")

    torch.backends.cudnn.allow_tf32 = False
    src = torch.from_numpy(
        np.stack([_test_image(256, 256, seed=300 + i) for i in range(16)]).astype(np.float32) / 127.5 - 1.0
    ).cuda()
    before, evals_before = fused_attention.launches, evals[0]
    every = task.generate_all_classes(src, num_steps=2)
    all_launches, all_evals = fused_attention.launches - before, evals[0] - evals_before
    hook.remove()
    per_class = torch.stack([task.generate(src, num_steps=2, target_class=c) for c in range(3)])
    # warm now (cuDNN's algorithms chosen for both shapes): the 48-tile call against three 16-tile calls
    all_s = cuda_ms(lambda: task.generate_all_classes(src, num_steps=2), repeats=5) / 1e3
    per_class_s = cuda_ms(lambda: [task.generate(src, num_steps=2, target_class=c) for c in range(3)], repeats=5) / 1e3
    err = (every - per_class).abs().max().item()
    tol = GENERATE_ALL_REL_TOL * max(1.0, per_class.abs().max().item())
    result = dict(card=card, warmup_s=warm_s, requests=requests, velocity_evals=total_evals, k1_launches=launches,
                  class_mean_abs_diffs=diffs, info=info, generate_all_classes_s=all_s, per_class_generate_s=per_class_s,
                  generate_all_classes_k1_launches=all_launches, generate_all_max_abs_err=err, generate_all_tol=tol)
    log("serve-any2any " + json.dumps(result))
    if (err > tol or all_launches == 0 or all_launches != all_evals or not torch.isfinite(every).all()
            or every.shape != (3, 16, 256, 256, 3)):
        raise AssertionError(f"generate_all_classes disagrees with per-class generate: {result}")
    return result


# phase 7's data and trainer for the eval CLIs (its overrides: quality_synthetic_256 with 256 training tiles)
EVAL_DATA = ["data=synthetic", "data.tile_size=256", "data.image_size=256", "data.n_train=256", "data.n_val=32",
             "data.n_test=32", "data.deterministic=true"]


def _cli(module, argv: list, root: Path):
    """``module.main(argv)`` with ``PROJECT_ROOT`` at ``root`` (its run
    directory goes there), its standard output captured: (result, output)."""
    import contextlib

    before = os.environ.get("PROJECT_ROOT")
    os.environ["PROJECT_ROOT"] = str(root)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result = module.main(argv)
    finally:
        os.environ["PROJECT_ROOT"] = before or str(REPO)
    return result, buf.getvalue()


def phase_eval(card: str, work: Path, train_summary: dict, any2any_summary: dict) -> dict:
    """The evaluation slice on the card, on phase 7's best checkpoint:
    ``eval`` (its test loss equal to phase 7's within 1e-6 relative),
    ``eval_quality`` (euler, 4 steps, 2 test batches: one JSON line,
    ``fid_comparable`` false, SSIM in [-1, 1]), ``ssim``/``psnr`` and the
    Inception ``pool3_features`` (numpy-drawn weights) on the card against the
    CPU, ``infer_wsi`` on phase 5's 1000×900 test image,
    ``infer_simple_flowmatching``, and ``infer_any2any`` on the any2any
    checkpoint."""
    import numpy as np
    import torch
    from PIL import Image

    from stain2stain_tpu_torch import eval as eval_cli
    from stain2stain_tpu_torch import eval_quality, infer_any2any, infer_simple_flowmatching, infer_wsi
    from stain2stain_tpu_torch.ops import inception, metrics
    from stain2stain_tpu_torch.utils.seed import seed_everything

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    best, data = train_summary["best_path"], f"data.data_dir={work / 'data'}"
    out: dict = {"card": card}
    seed_everything(0)  # what a fresh eval process starts from: phase 7's seed (quality_synthetic_256)
    t0 = time.perf_counter()
    got, _ = _cli(eval_cli, EVAL_DATA + [data, "data.batch_size=32", "data.cache=device", "trainer.accelerator=gpu",
                                         "trainer.precision=bf16-mixed", f"ckpt_path={best}",
                                         "extras.print_config=false"], work)
    out["eval"] = dict(test_loss=got["test/loss"], phase7_test_loss=train_summary["test_loss"],
                       s=time.perf_counter() - t0)
    rel = abs(got["test/loss"] - train_summary["test_loss"]) / abs(train_summary["test_loss"])
    out["eval"]["rel_diff"] = rel
    log("eval " + json.dumps(out["eval"]))
    if rel > 1e-6:
        raise AssertionError(f"eval's test loss differs from phase 7's: {out['eval']}")

    infer = EVAL_DATA + [data, "data.batch_size=16", f"ckpt_path={best}", "model.solver.solver=euler"]
    t0 = time.perf_counter()
    quality, printed = _cli(eval_quality, infer + ["num_steps=4", "n_batches=2"], work)
    lines = [ln for ln in printed.splitlines() if ln.strip()]
    out["eval_quality"] = dict(quality, s=time.perf_counter() - t0)
    log("eval-quality " + json.dumps(out["eval_quality"]))
    if (len(lines) != 1 or json.loads(lines[0]) != quality or quality["fid_comparable"] is not False
            or not -1.0 <= quality["ssim"] <= 1.0 or not math.isfinite(quality["fid"])):
        raise AssertionError(f"eval_quality printed {printed!r}")

    rng = np.random.default_rng(8)
    a = rng.uniform(0, 1, (8, 256, 256, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    pairs = {dev: (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)) for dev in ("cuda", "cpu")}
    vals = {dev: (float(metrics.ssim(*ab)), float(metrics.psnr(*ab))) for dev, ab in pairs.items()}
    out["metrics"] = dict(ssim_card=vals["cuda"][0], ssim_cpu=vals["cpu"][0], psnr_card=vals["cuda"][1],
                          psnr_cpu=vals["cpu"][1],
                          ssim_ms=cuda_ms(lambda: metrics.ssim(*pairs["cuda"]), repeats=10),
                          psnr_ms=cuda_ms(lambda: metrics.psnr(*pairs["cuda"]), repeats=10))
    x = rng.uniform(0, 1, (4, 256, 256, 3)).astype(np.float32)
    feats = {dev: inception.pool3_features(inception.init_params(seed=0, device=dev), torch.from_numpy(x).to(dev))
             for dev in ("cuda", "cpu")}
    ref = feats["cpu"]
    out["metrics"]["pool3_rel_err"] = (feats["cuda"].cpu() - ref).abs().max().item() / ref.abs().max().item()
    params = inception.init_params(seed=0, device="cuda")
    xc = torch.from_numpy(x).cuda()
    out["metrics"]["pool3_ms_batch4"] = cuda_ms(lambda: inception.pool3_features(params, xc), repeats=5)
    log("eval-metrics " + json.dumps(out["metrics"]))
    if (abs(vals["cuda"][0] - vals["cpu"][0]) > 1e-5 or abs(vals["cuda"][1] - vals["cpu"][1]) > 1e-5
            or out["metrics"]["pool3_rel_err"] > 1e-4):
        raise AssertionError(f"the metrics on the card disagree with the CPU: {out['metrics']}")

    slide = _test_image(1000, 900, seed=1000 * 900)
    np.save(work / "slide.npy", slide)
    t0 = time.perf_counter()
    path, _ = _cli(infer_wsi, [f"input={work / 'slide.npy'}", f"output={work / 'slide_out.png'}", f"ckpt_path={best}",
                               "num_steps=2", "model.solver.solver=euler"], work)
    translated = np.asarray(Image.open(path))
    out["infer_wsi"] = dict(shape=list(translated.shape), s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    panels, _ = _cli(infer_simple_flowmatching, infer + ["num_steps=2", "n_images=4"], work)
    simple = sorted(panels.iterdir())
    out["infer_simple_flowmatching"] = dict(panels=len(simple), panel_shape=list(np.asarray(Image.open(simple[0])).shape),
                                            s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    panels, _ = _cli(infer_any2any, [
        "model=class_conditional_flow_matching", "data=class_conditional_he_amyloid", f"data.data_dir={work / 'domains'}",
        "data.class_folder_mapping={0: HE, 1: IHC, 2: Grayscale}", "data.batch_size=16",
        f"ckpt_path={any2any_summary['best_path']}", "num_steps=2", "n_images=4", "model.solver.solver=euler"], work)
    any2any = sorted(panels.iterdir())
    out["infer_any2any"] = dict(panels=len(any2any), panel_shape=list(np.asarray(Image.open(any2any[0])).shape),
                                s=time.perf_counter() - t0)
    log("eval-clis " + json.dumps({k: out[k] for k in ("infer_wsi", "infer_simple_flowmatching", "infer_any2any")}))
    if (translated.shape != slide.shape or out["infer_simple_flowmatching"]["panel_shape"] != [256, 768, 3]
            or len(simple) != 4 or len(any2any) != 4 or out["infer_any2any"]["panel_shape"] != [256, 1024, 3]):
        raise AssertionError(f"an inference CLI wrote the wrong images: {out}")
    return out


def make_mask_data(work: Path) -> None:
    """The synthetic 512-px trees of the mask paths, made by the port's
    generators: ``data-mask`` (binary masks, ``MASK_TILES``) and
    ``data-pos-neg`` (``POS_NEG_TILES``: a positive CSV dataset and negative
    folder pairs)."""
    from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset, generate_pos_neg_layout

    n_train, n_val, n_test = MASK_TILES
    generate_paired_dataset(work / "data-mask", n_train=n_train, n_val=n_val, n_test=n_test, size=512, seed=0,
                            with_mask=True)
    generate_pos_neg_layout(work / "data-pos-neg", size=512, seed=0, **POS_NEG_TILES)


def phase_infer_conditional(card: str, work: Path, summary: dict, task) -> dict:
    """``infer_conditional`` on ``train-masked-conditioned``'s best checkpoint,
    with the real mask and with ``+zero_mask=true`` (euler, 2 steps, 4 test
    tiles each): both write source / generated / target / mask panels, the
    mask panels agree and the generated ones differ. Then the trained toggled
    task (euler, 2 steps) behind ``TranslationServer`` over HTTP: one request
    on phase 5's 1000×900 region, unconditioned (``generate(mask=None)``
    runs on a zero mask), K1-fwd six times per velocity evaluation. A
    ``MaskConditionedFlowMatchingModule`` on the same net is refused by
    ``generate(mask=None)`` and by the server."""
    import numpy as np
    import torch
    from PIL import Image

    from stain2stain_tpu_torch import infer_conditional
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.server import TranslationServer
    from stain2stain_tpu_torch.tasks import MaskConditionedFlowMatchingModule, ToggleMaskFlowMatchingModule

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for inference
    torch.backends.cudnn.allow_tf32 = True
    out: dict = {"card": card}
    argv = ["model=conditional_flow_matching_mask_toggeling", "data=paired_data_mask_he_amyloid",
            f"data.data_dir={work / 'data-mask'}", "data.csv_file_name=metadata.csv", "data.batch_size=4",
            f"ckpt_path={summary['best_path']}", "num_steps=2", "n_images=4", "model.solver.solver=euler"]
    rows = {}
    for label, extra in (("mask", []), ("zero_mask", ["+zero_mask=true"])):
        t0 = time.perf_counter()
        panels, _ = _cli(infer_conditional, argv + extra, work)
        files = sorted(panels.iterdir())
        rows[label] = [np.asarray(Image.open(f)).astype(np.int16) for f in files]
        out[label] = dict(panels=len(files), panel_shape=list(rows[label][0].shape), s=time.perf_counter() - t0)
    # source | generated | target | mask, 512 px each
    gen_diff = float(np.mean([np.abs(a[:, 512:1024] - b[:, 512:1024]).mean() for a, b in zip(rows["mask"],
                                                                                             rows["zero_mask"])]))
    same_rest = all(np.array_equal(a[:, :512], b[:, :512]) and np.array_equal(a[:, 1024:], b[:, 1024:])
                    for a, b in zip(rows["mask"], rows["zero_mask"]))
    out["generated_mean_abs_diff"] = gen_diff
    log("infer-conditional " + json.dumps(out))
    if (out["mask"]["panels"] != 4 or out["zero_mask"]["panels"] != 4 or out["mask"]["panel_shape"] != [512, 2048, 3]
            or not same_rest or gen_diff <= 0.0):
        raise AssertionError(f"infer_conditional wrote the wrong panels, or the mask changed nothing: {out}")

    net = task.net
    attention = summary["attention_layers"]
    toggle = ToggleMaskFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    img = _test_image(1000, 900, seed=1000 * 900)
    served = _serve_one_request(toggle, img)
    launches, total_evals = served["launches"]["K1-fwd"], served["net_passes"]
    request = dict(card=card, status=served["status"], latency_s=served["latency_s"], tiles=served["tiles"],
                   tiles_per_s=served["tiles_per_s"], warmup_s=served["warmup_s"], velocity_evals=total_evals,
                   k1_launches=launches, mean_abs_change=served["mean_abs_change"])
    log("serve-toggle-request " + json.dumps(request))
    out["serve"] = request
    if (request["status"] != 200 or served["shape"] != list(img.shape) or launches == 0
            or launches != attention * total_evals):
        raise AssertionError(f"the toggled model served wrongly: {request}")

    conditioned = MaskConditionedFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    refused = []
    for what, call in (("generate", lambda: conditioned.generate(torch.zeros(1, 256, 256, 3), num_steps=2)),
                       ("server", lambda: TranslationServer(conditioned, num_steps=2, tile=256, overlap=32, batch=1))):
        try:
            call()
        except ValueError as e:
            refused.append(what if "requires the conditioning mask" in str(e) else f"{what}: {e}")
    out["conditioned_refused"] = refused
    log("conditioned-refused " + json.dumps(refused))
    if refused != ["generate", "server"]:
        raise AssertionError(f"the mask-conditioned task was not refused without a mask: {refused}")
    return out


def phase_mask_grad_parity() -> dict:
    """One f32 train step of the mask-conditioned net
    (``model=conditional_flow_matching_masked_condition``: 4 → 3 channels,
    attention at level 3 and in the mid block) at batch 2, 256 px, dropout
    0, on the card (TF32 off) against the same step through the plain path
    on the CPU: loss and every parameter gradient; K1-fwd and K1-bwd six
    times each (T 1024 at level 3 and in the mid block)."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.attention import fused_attention, fused_attention_backward
    from stain2stain_tpu_torch.tasks import MaskConditionedFlowMatchingModule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("mask-grad-parity: TF32 off for matmul and cuDNN")
    cfg = compose(REPO / "configs", "train.yaml", ["model=conditional_flow_matching_masked_condition",
                                                    "model.net.dropout=0.0"])
    torch.manual_seed(0)
    nets = {dev: instantiate(cfg.model.net, device=dev) for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # jitter every parameter: ADM zero-inits the output convs
        for p in nets["cpu"].parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    nets["cuda"].load_state_dict(nets["cpu"].state_dict())
    rng = np.random.default_rng(7)
    batch = tuple(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8) for _ in range(2))
    batch += ((rng.random((2, 256, 256)) > 0.7).astype(np.uint8),)
    t = torch.tensor([0.3, 0.8])
    out = {}
    for dev, net in nets.items():
        task = MaskConditionedFlowMatchingModule(net=net, device=dev)
        prepared = task.prepare_batch(batch, train=False)
        before = (fused_attention.launches, fused_attention_backward.launches)
        t0 = time.perf_counter()
        loss, _ = task.loss_and_metrics(prepared, train=True, t=t)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        launches = (fused_attention.launches - before[0], fused_attention_backward.launches - before[1])
        out[dev] = (loss.item(), {n: p.grad.detach().cpu() for n, p in net.named_parameters()},
                    time.perf_counter() - t0, launches)
    (loss_gpu, g_gpu, gpu_s, launches), (loss_cpu, g_cpu, cpu_s, _) = out["cuda"], out["cpu"]
    ref_max = max(g.abs().max().item() for g in g_cpu.values())
    err = max((g_gpu[n] - g_cpu[n]).abs().max().item() for n in g_cpu)
    worst = max(g_cpu, key=lambda n: (g_gpu[n] - g_cpu[n]).abs().max().item())
    row = dict(loss_card=loss_gpu, loss_cpu=loss_cpu, max_abs_grad_err=err, worst_param=worst,
               ref_max_abs_grad=ref_max, tol=GRAD_REL_TOL * ref_max, card_step_s=gpu_s, cpu_step_s=cpu_s,
               k1_fwd_launches=launches[0], k1_bwd_launches=launches[1])
    row["ok"] = (err <= row["tol"] and abs(loss_gpu - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu))
                 and launches == (6, 6) and all(torch.isfinite(g).all() for g in g_gpu.values()))
    log("mask-grad-parity " + json.dumps(row))
    if not row["ok"]:
        raise AssertionError(f"mask-conditioned f32 gradients on the card disagree with the CPU plain path: {row}")
    return row


def mask_phases(card: str, work: Path, timed=lambda label, fn, *args: fn(*args)) -> dict:
    """Phases 16–18 and 24 in a row, their data under ``work``: the mask
    trees, ``train-masked-conditioned``, ``phase_infer_conditional`` and
    ``phase_serve_mask_bound`` on its task, the three short paths,
    ``phase_mask_grad_parity``. ``timed(label,
    fn, *args)`` runs each phase (``main`` records its seconds)."""
    import torch

    # The mask-conditioned path peaks at 67.5 GiB allocated in a fresh process;
    # after phases 3-15 the caching allocator's split blocks left 11 GiB reserved
    # but unusable and its step ran out of memory. Segments that grow in place
    # (set here, after the earlier phases, so those run under the default
    # allocator as before) keep the reserve near what is allocated.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    log("mask-phases " + json.dumps({"allocator": "expandable_segments:True",
                                     "allocated_gib_before": torch.cuda.memory_allocated() / 2**30,
                                     "reserved_gib_before": torch.cuda.memory_reserved() / 2**30}))
    timed("mask-data", make_mask_data, work)
    cond_summary, cond_objects = timed("train-masked-conditioned", phase_train, card, work, "train-masked-conditioned")
    infer_cond = timed("infer-conditional", phase_infer_conditional, card, work, cond_summary, cond_objects["model"])
    serve_bound = timed("serve-mask-bound", phase_serve_mask_bound, card, cond_objects["model"])
    del cond_objects
    gc.collect()
    torch.cuda.empty_cache()
    short = {}
    for name in ("train-masked", "train-roi", "train-pos-neg"):
        short[name], _ = timed(name, phase_train, card, work, name)
        gc.collect()
        torch.cuda.empty_cache()
    grad = timed("mask-grad-parity", phase_mask_grad_parity)
    return {"train-masked-conditioned": cond_summary, "infer-conditional": infer_cond,
            "serve-mask-bound": serve_bound, "short": short, "mask-grad-parity": grad}


def zero_kernel_launches() -> None:
    """Every hand-written kernel's launch count to 0 (K1-fwd, K1-bwd, K2-K5)."""
    from stain2stain_tpu_torch.ops import zero_launches

    zero_launches()


def kernel_launches() -> dict:
    """{kernel: launches since the counts were zeroed}."""
    from stain2stain_tpu_torch.ops import launches

    return launches()


def make_multiclass_data(work: Path) -> None:
    """``data-multiclass``: ``MULTICLASS_TILES`` 256-px tiles with 2-class
    masks (the port's generator, ``num_mask_classes=2``), under the columns
    ``he_filepath``, ``ihc_filepath`` and ``graywhite_filepath``."""
    from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset

    n_train, n_val, n_test = MULTICLASS_TILES
    generate_paired_dataset(work / "data-multiclass", n_train=n_train, n_val=n_val, n_test=n_test, size=256, seed=0,
                            with_mask=True, num_mask_classes=2)


def _serve_one_request(task, img, **gen_kwargs) -> dict:
    """``task`` behind ``TranslationServer`` (tile 256, overlap 32, batch 16,
    its ``generate`` with 2 steps and ``gen_kwargs`` bound) over HTTP on
    127.0.0.1: one PNG request of ``img``; the response, its time, the
    server, and from the warm-up on the net's forward passes (a multitask
    net's encoder passes) and every kernel's launches."""
    import numpy as np
    from PIL import Image

    from stain2stain_tpu_torch.server import TranslationServer, serve_forever
    from stain2stain_tpu_torch.wsi import tile_starts

    passes = [0]
    net = getattr(task.net, "encoder", task.net)
    hook = net.register_forward_hook(lambda *_: passes.__setitem__(0, passes[0] + 1))
    # ---- the main path: counts zeroed just before, read just after --------
    zero_kernel_launches()
    t0 = time.perf_counter()
    server = TranslationServer(task, num_steps=2, tile=256, overlap=32, batch=16, **gen_kwargs)
    warm_s = time.perf_counter() - t0
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(server, "127.0.0.1", 0, ready), daemon=True)
    thread.start()
    try:
        if not ready.wait(30):
            raise RuntimeError("server did not bind")
        req = urllib.request.Request(f"http://127.0.0.1:{server.bound_port}/translate", data=_png(img),
                                     headers={"Content-Type": "image/png"})
        t1 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, payload = resp.status, resp.read()
        latency = time.perf_counter() - t1
    finally:
        if server.httpd is not None:
            server.httpd.shutdown()
        thread.join(timeout=30)
    launches = kernel_launches()
    # ---- end of the main path ---------------------------------------------
    hook.remove()
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")
    served = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
    tiles = len(tile_starts(img.shape[0], 256, 224)) * len(tile_starts(img.shape[1], 256, 224))
    return dict(status=status, latency_s=latency, tiles=tiles, tiles_per_s=tiles / latency, warmup_s=warm_s,
                net_passes=passes[0], launches=launches, shape=list(served.shape), server=server,
                mean_abs_change=float(np.abs(served.astype(np.float32) - img).mean()))


def phase_infer_multitask(card: str, work: Path, name: str, summary: dict, task, datamodule) -> dict:
    """``infer_multitask_multiclassloss`` on a multitask path's best checkpoint
    (euler, 2 steps, 4 test tiles): source / generated / target / predicted
    mask / true mask panels, the predicted mask binary (0 or 255: class ids
    in {0, 1}); the trained task's segmentation head on 4 tiles of the run's
    validation loader gives ids in {0, 1} (multiclass) or a {0, 1} mask
    (binary). For the
    binary study, then the task (euler, 2 steps) behind ``TranslationServer``:
    one request on phase 5's 1000×900 region. No K1–K5 launch in any."""
    import numpy as np
    import torch
    from PIL import Image

    from stain2stain_tpu_torch import infer_multitask_multiclassloss
    from stain2stain_tpu_torch.ops.solvers import SolverConfig

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for inference
    torch.backends.cudnn.allow_tf32 = True
    multiclass = name == "train-multitask-multiclass"
    px = 256 if multiclass else 512
    if multiclass:
        argv = ["model=conditional_flow_matching_multitask_multiclass", "+num_classes=2",
                "data=paired_data_multiclass_seg_mask", f"data.data_dir={work / 'data-multiclass'}",
                "data.target_column=ihc_filepath", "data.image_size=256"]
    else:
        argv = ["model=conditional_flow_matching_multitask", "data=paired_data_mask_he_amyloid",
                f"data.data_dir={work / 'data-mask'}"]
    argv += ["data.csv_file_name=metadata.csv", "data.batch_size=4", *BATCH_NORM, f"ckpt_path={summary['best_path']}",
             "num_steps=2", "n_images=4", "model.solver.solver=euler"]
    out: dict = {"card": card}
    # ---- the main path: counts zeroed just before, read just after --------
    zero_kernel_launches()
    t0 = time.perf_counter()
    panels, _ = _cli(infer_multitask_multiclassloss, argv, work)
    launches = kernel_launches()
    # ---- end of the main path ---------------------------------------------
    rows = [np.asarray(Image.open(f)) for f in sorted(panels.iterdir())]
    pred = np.concatenate([r[:, 3 * px:4 * px].ravel() for r in rows]) if rows else np.zeros(0)
    out["infer"] = dict(panels=len(rows), panel_shape=list(rows[0].shape) if rows else None,
                        pred_mask_values=sorted(int(v) for v in np.unique(pred)), launches=launches,
                        s=time.perf_counter() - t0)
    src = task.prepare_batch(task.device_fields(next(iter(datamodule.val_dataloader()))))[0][:4]
    with torch.no_grad():
        ids = task.predict_mask(task.forward_segmentation(src))
    out["seg_head_values"] = sorted(int(v) for v in torch.unique(ids).tolist())
    log(f"{name}-infer " + json.dumps(out))
    if (len(rows) != 4 or out["infer"]["panel_shape"] != [px, 5 * px, 3] or not set(out["infer"]["pred_mask_values"])
            <= {0, 255} or not set(out["seg_head_values"]) <= {0, 1} or any(launches.values())):
        raise AssertionError(f"infer_multitask_multiclassloss wrote the wrong panels, or a kernel launched: {out}")
    if multiclass:
        return out
    serve_task = type(task)(net=task.net, solver=SolverConfig("euler"), time_emb_dim=task.time_emb_dim)
    img = _test_image(1000, 900, seed=1000 * 900)
    request = dict(_serve_one_request(serve_task, img), card=card)
    del request["server"]
    out["serve"] = request
    log("serve-multitask-request " + json.dumps(request))
    if request["status"] != 200 or request["shape"] != list(img.shape) or any(request["launches"].values()):
        raise AssertionError(f"the multitask task served wrongly: {request}")
    return out


def _multitask_step(task, batch: tuple, t, dtype) -> tuple:
    """One train step's (loss, gradients, running statistics, seconds, kernel
    launches) of ``task`` with its net and inputs in ``dtype``."""
    import torch

    task.net.to(dtype)
    task.net.dtype = dtype
    prepared = tuple(x.to(dtype) if x.is_floating_point() else x for x in task.prepare_batch(batch, train=False))
    zero_kernel_launches()
    t0 = time.perf_counter()
    loss, _ = task.loss_and_metrics(prepared, train=True, t=t.to(dtype))
    loss.backward()
    if task.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = {k: v.detach().double().cpu() for k, v in task.net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    grads = {n: p.grad.detach().double().cpu() for n, p in task.net.named_parameters()}
    return loss.item(), grads, stats, seconds, kernel_launches()


def _max_err(a: dict, b: dict) -> tuple[float, str]:
    errs = {n: (a[n] - b[n]).abs().max().item() for n in b}
    worst = max(errs, key=errs.get) if errs else ""
    return errs.get(worst, 0.0), worst


def phase_multitask_grad_parity() -> dict:
    """One f32 train step of the full-width multitask net
    (``experiment=multitask_he2ihc_amyloid``: features 64…1024, decoders
    512…64) at batch 2, 256 px, on the card (TF32 off, deterministic cuDNN)
    against the same step on the CPU, under ``norm="group"`` (the configs'
    default) and ``norm="batch"``: the loss, the BatchNorm running statistics
    after the step within ``BN_STATS_TOL``, no K1–K5 launch, and every
    parameter gradient within ``GRAD_REL_TOL`` × max|g|.

    Under BatchNorm two f32 steps cannot meet that bound: the gradients of
    the first convs move by about 1e-3 × max|g| under f32 rounding (on an
    H100 and its host, the CPU's f32 step lay 0.95e-3 × max|g| from the same
    step in float64, the card's float64 step 0.38e-3 from the CPU's; the
    numbers are in PERF.md). So under
    BatchNorm the step also runs in float64 (the net's and the inputs'
    dtype; the losses and the time embedding stay f32) on both: the card's
    float64 gradients must lie within ``GRAD_REL_TOL`` × max|g| of the
    CPU's, and the card's f32 gradients no further from the CPU's float64
    step than ``F32_FLOOR_FACTOR`` × the CPU's own f32 gradients."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.utils.utils import instantiate_task

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic, benchmark = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    log("multitask-grad-parity: TF32 off for matmul and cuDNN, deterministic cuDNN")
    rng = np.random.default_rng(11)
    batch = tuple(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8) for _ in range(2))
    batch += ((rng.random((2, 256, 256)) > 0.7).astype(np.uint8),)
    t = torch.tensor([0.3, 0.8])
    rows = {}
    try:
        for norm in ("group", "batch"):
            cfg = compose(REPO / "configs", "train.yaml",
                          ["experiment=multitask_he2ihc_amyloid"] + (BATCH_NORM if norm == "batch" else []))
            torch.manual_seed(0)
            state = instantiate_task(cfg.model, device="cpu").net.state_dict()
            dtypes = (torch.float32, torch.float64) if norm == "batch" else (torch.float32,)
            steps = {}
            for dtype in dtypes:
                for dev in ("cuda", "cpu"):
                    task = instantiate_task(cfg.model, device=dev)
                    task.net.load_state_dict(state)
                    steps[dev, dtype] = _multitask_step(task, batch, t, dtype)
                    del task
            (loss_gpu, g_gpu, s_gpu, gpu_s, launches), (loss_cpu, g_cpu, s_cpu, cpu_s, _) = (
                steps["cuda", torch.float32], steps["cpu", torch.float32])
            ref_max = max(g.abs().max().item() for g in g_cpu.values())
            err, worst = _max_err(g_gpu, g_cpu)
            stats_err = max([(s_gpu[k] - s_cpu[k]).abs().max().item() for k in s_cpu], default=0.0)
            row = dict(norm=norm, loss_card=loss_gpu, loss_cpu=loss_cpu, max_abs_grad_err=err, worst_param=worst,
                       ref_max_abs_grad=ref_max, tol=GRAD_REL_TOL * ref_max, batch_norms=len(s_cpu) // 2,
                       max_abs_stats_err=stats_err, stats_tol=BN_STATS_TOL, card_step_s=gpu_s, cpu_step_s=cpu_s,
                       n_params=sum(g.numel() for g in g_cpu.values()), launches=launches)
            ok = (abs(loss_gpu - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu)) and stats_err <= BN_STATS_TOL
                  and (norm == "group") == (not s_cpu) and not any(launches.values())
                  and all(torch.isfinite(g).all() for g in g_gpu.values()))
            if norm == "group":
                ok = ok and err <= row["tol"]
            else:
                g64_gpu, g64_cpu = steps["cuda", torch.float64][1], steps["cpu", torch.float64][1]
                row["f64_card_vs_cpu"], row["f64_worst_param"] = _max_err(g64_gpu, g64_cpu)
                row["f32_card_vs_cpu_f64"], _ = _max_err(g_gpu, g64_cpu)
                row["f32_cpu_vs_cpu_f64"], _ = _max_err(g_cpu, g64_cpu)
                row["f32_floor_bound"] = F32_FLOOR_FACTOR * row["f32_cpu_vs_cpu_f64"]
                row["cpu_f64_step_s"] = steps["cpu", torch.float64][3]
                ok = (ok and row["f64_card_vs_cpu"] <= row["tol"]
                      and row["f32_card_vs_cpu_f64"] <= row["f32_floor_bound"])
            row["ok"] = ok
            log("multitask-grad-parity " + json.dumps(row))
            rows[norm] = row
            del steps
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = deterministic, benchmark
    if not all(r["ok"] for r in rows.values()):
        raise AssertionError(f"multitask gradients or statistics on the card disagree with the CPU: {rows}")
    return rows


def multitask_phases(card: str, work: Path, timed=lambda label, fn, *args: fn(*args)) -> dict:
    """Phases 19–21 in a row, their data under ``work`` (phase 16's masked
    tree, made here if absent, and the 2-class tree): ``train-multitask`` and
    ``phase_infer_multitask`` on its task, ``train-multitask-multiclass`` and
    its inference, ``phase_multitask_grad_parity``."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    if not (work / "data-mask" / "metadata.csv").exists():
        timed("mask-data", make_mask_data, work)
    timed("multiclass-data", make_multiclass_data, work)
    out = {}
    for name in MULTITASK_PATHS:
        summary, objects = timed(name, phase_train, card, work, name)
        infer = timed(name.replace("train", "infer"), phase_infer_multitask, card, work, name, summary,
                      objects["model"], objects["datamodule"])
        out[name] = (summary, infer)
        del objects
        gc.collect()
        torch.cuda.empty_cache()
    out["multitask-grad-parity"] = timed("multitask-grad-parity", phase_multitask_grad_parity)
    return out


# A tracking service's client (wandb) may be installed where there is no network and no API key: the loggers'
# client branch would then try to log in (and the client's error reporting to reach its server). So the phases
# that run logger=wandb make the clients unimportable in this process: the loggers take their local path, as
# where no client is installed, and ckpt_path=wandb-artifact:// reads their local cache.
TRACKING_CLIENTS = ("wandb", "mlflow", "neptune", "comet_ml", "aim")


def block_tracking_clients() -> None:
    """``import <client>`` raises ImportError from now on in this process."""
    for name in TRACKING_CLIENTS:
        sys.modules[name] = None


def resume_probe(expected: str):
    """A training callback (built from the config by ``_target_``) for a run
    resumed from the checkpoint directory ``expected``: every kernel's launch
    count when the fit loop starts and when it ends (the profiled window lies
    between), and whether the weights the first resumed step starts from
    equal the checkpoint's, bit for bit (read when the callback is built,
    before the run logs a model of its own under the same reference)."""
    import torch

    from stain2stain_tpu_torch.training import Callback

    class ResumeProbe(Callback):
        def __init__(self):
            self.expected = torch.load(Path(expected) / "state.pt", map_location="cpu", weights_only=True)["model"]
            self.fit_start = self.fit_end = self.weights_equal = None

        def on_fit_start(self, trainer, task):
            self.fit_start = kernel_launches()

        def on_train_epoch_start(self, trainer, task):
            if self.weights_equal is None:
                got = task.net.state_dict()
                self.weights_equal = set(got) == set(self.expected) and all(
                    torch.equal(got[k].cpu(), v) for k, v in self.expected.items())
                self.expected = None

        def on_fit_end(self, trainer, task):
            self.fit_end = kernel_launches()

    return ResumeProbe()


def _artifact_cache(work: Path) -> Path:
    """Where ``WandbLogger.log_model`` mirrors ``WANDB_REF`` (``$WANDB_CACHE_DIR`` under ``work``)."""
    return work / "wandb_artifacts" / WANDB_REF.replace("/", "_").replace(":", "_")


def phase_train_wandb(card: str, work: Path) -> dict:
    """``train-wandb``: phase 7's flagship path (bf16-mixed, 256 px, batch 32)
    under ``logger=wandb`` with no wandb client (:func:`block_tracking_clients`),
    ``WANDB_CACHE_DIR`` in ``work``, 4 steps: the logger's JSONL holds the step metrics and a
    ``model_artifact`` record of the best checkpoint with its
    ``artifact_ref``, and the cache holds that checkpoint, byte for byte."""
    import filecmp

    block_tracking_clients()
    os.environ["WANDB_CACHE_DIR"] = str(work / "wandb_artifacts")
    summary, _ = phase_train(card, work, "train-wandb")
    records = [json.loads(line) for line in (work / "out-train-wandb" / "wandb" / "metrics.jsonl").read_text()
               .splitlines()]
    artifacts = [r for r in records if "model_artifact" in r]
    cache = _artifact_cache(work)
    cached = all((cache / f).is_file() for f in ("state.pt", "meta.json")) and all(
        filecmp.cmp(cache / f, Path(summary["best_path"]) / f, shallow=False) for f in ("state.pt", "meta.json"))
    out = dict(card=card, step_ms_median_2_4=summary["step_ms_median_3_8"], global_step=summary["global_step"],
               k1_fwd_launches=summary["k1_fwd_launches"], k1_bwd_launches=summary["k1_bwd_launches"],
               jsonl_records=len(records), metric_keys=sorted({k for r in records if "step" in r for k in r}),
               artifacts=artifacts, cache=str(cache.relative_to(work)), cache_equals_best=cached)
    log("train-wandb-logger " + json.dumps(out))
    if (summary["global_step"] != 4 or not any("train/loss" in r for r in records)
            or not any("val/loss" in r for r in records) or not artifacts
            or artifacts[-1]["artifact_ref"] != WANDB_REF or artifacts[-1]["model_artifact"] != summary["best_path"]
            or not cached):
        raise AssertionError(f"the wandb logger did not record the run or mirror its checkpoint: {out}")
    return {**summary, "logger": out}


def phase_train_resume(card: str, work: Path, wandb_summary: dict) -> dict:
    """``train-resume``: ``train-wandb``'s overrides with
    ``ckpt_path=wandb-artifact://<ref>``, ``trainer.max_epochs=2`` and
    ``+trainer.profiler=advanced``: ``global_step`` goes on from 4 to 8, the
    first resumed step starts from the cached checkpoint's weights bit for
    bit, and the trainer's Chrome trace under ``<default_root_dir>/profile``
    names the K1-fwd and K1-bwd kernels as often as their launch counters
    counted them over the profiled window (K1-bwd's bf16 route: one dq
    kernel a call). The median step against ``train-wandb``'s: the
    profiler's cost."""
    block_tracking_clients()
    probe_cfg = {"resume_probe": {"_target_": f"{__name__}.resume_probe", "expected": str(_artifact_cache(work))}}
    summary, objects = phase_train(card, work, "train-resume", probe_cfg)
    probe = next(cb for cb in objects["callbacks"] if type(cb).__name__ == "ResumeProbe")
    window = {k: probe.fit_end[k] - probe.fit_start[k] for k in probe.fit_end}
    traces = sorted((work / "out-train-resume" / "profile").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"the profiler wrote {len(traces)} traces, not one: {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    traced = {"K1-fwd": sum("attention_fwd" in n for n in kernels), "K1-bwd": sum("attention_bwd_dq" in n for n in kernels)}
    names = sorted({m.group(0) for n in kernels for m in [re.search(r"attention_\w+", n)] if m})
    no_profiler, profiled = wandb_summary["step_ms_median_3_8"], summary["step_ms_median_3_8"]
    out = dict(card=card, global_step=summary["global_step"], weights_equal=probe.weights_equal,
               trace=str(traces[0].relative_to(work)), trace_mb=traces[0].stat().st_size / 2**20,
               trace_kernel_events=len(kernels), traced=traced, launches_in_window=window, attention_kernels=names,
               step_ms_median_2_4=profiled, step_ms_without_profiler=no_profiler,
               profiler_cost_ms=profiled - no_profiler, profiler_cost_share=profiled / no_profiler - 1.0,
               step_ms=summary["step_ms"])
    log("train-resume-profile " + json.dumps(out))
    if (summary["global_step"] != 8 or objects["trainer"].current_epoch != 1 or probe.weights_equal is not True
            or window["K1-bwd"] == 0 or traced != {k: window[k] for k in traced}):
        raise AssertionError(f"the resumed run did not go on from the logged model, or its trace does not show "
                             f"the kernels the counters counted: {out}")
    return {**summary, "profile": out}


def phase_serve_mask_bound(card: str, trained) -> dict:
    """``serve-mask-bound``: the mask-conditioned task on phase 16's trained
    net (euler, 2 steps) behind ``TranslationServer(task, …, mask=zeros)``
    (tile 256, overlap 32, batch 16): one HTTP request on phase 5's 1000×900
    region (K1-fwd f32 six times per velocity evaluation, the request's
    latency), then ``server.translate`` against ``translate_large_image``
    driven by ``task.generate(x, mask=zeros)`` directly, within
    ``BOUND_MASK_TOL``; a ones mask gives another image."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.models.unet import AttentionBlock
    from stain2stain_tpu_torch.ops.image import denormalize_np, normalize_uint8_np
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.tasks import MaskConditionedFlowMatchingModule
    from stain2stain_tpu_torch.wsi import translate_large_image

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults for inference
    torch.backends.cudnn.allow_tf32 = True
    task = MaskConditionedFlowMatchingModule(net=trained.net, solver=SolverConfig("euler"))
    attention = sum(isinstance(m, AttentionBlock) for m in task.net.modules())
    img = _test_image(1000, 900, seed=1000 * 900)
    served = _serve_one_request(task, img, mask=np.zeros((16, 256, 256, 1), np.float32))
    server = served.pop("server")
    got = server.translate(img)

    def direct(value: float):
        mask = torch.full((16, 256, 256, 1), value, device=task.device)

        def gen(batch):
            x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(task.device)
            return task.generate(x, num_steps=2, mask=mask).float().cpu().numpy()

        return gen

    normalized = normalize_uint8_np(img)
    ref, ones = (denormalize_np(translate_large_image(direct(v), normalized, tile=256, overlap=32, batch_size=16))
                 for v in (0.0, 1.0))
    launches, passes = served["launches"]["K1-fwd"], served["net_passes"]
    out = dict(card=card, status=served["status"], latency_s=served["latency_s"], tiles=served["tiles"],
               tiles_per_s=served["tiles_per_s"], warmup_s=served["warmup_s"], velocity_evals=passes,
               k1_launches=launches, attention_layers=attention, max_abs_err_vs_direct=float(np.abs(got - ref).max()),
               tol=BOUND_MASK_TOL, ones_mask_mean_abs_diff=float(np.abs(ones - ref).mean()),
               other_launches={k: v for k, v in served["launches"].items() if k != "K1-fwd"})
    log("serve-mask-bound " + json.dumps(out))
    if (out["status"] != 200 or served["shape"] != list(img.shape) or attention != 6 or launches == 0
            or launches != attention * passes or any(out["other_launches"].values())
            or not out["max_abs_err_vs_direct"] <= BOUND_MASK_TOL or not out["ones_mask_mean_abs_diff"] > 0.0):
        raise AssertionError(f"the server with a bound mask served wrongly: {out}")
    return out


def phase_mnist_sweep(card: str, work: Path) -> dict:
    """``mnist-sweep``: ``python -m stain2stain_tpu_torch.train -m
    hparams_search=mnist_optuna experiment=example trainer.accelerator=gpu``
    through the entry point's ``main`` on the synthetic digits, the study
    journaled under ``work`` (with ``MNIST_SWEEP_CUT``): the journal holds
    every trial with a finite value, each trial's CSV log holds
    ``val/acc_best`` as the running max of ``val/acc`` after every epoch and
    its last value is the trial's value; the best value and its parameters.
    K1–K5 launch 0 times."""
    import torch

    from stain2stain_tpu_torch import train as train_cli
    from stain2stain_tpu_torch.config import compose

    journal = work / "mnist-study.jsonl"
    argv = MNIST_SWEEP + MNIST_SWEEP_CUT + [f"paths.log_dir={work / 'mnist-logs'}",
                                            f"paths.data_dir={work / 'mnist-data'}", f"+sweeper.storage={journal}"]
    cfg = compose(REPO / "configs", "train.yaml", argv[1:])
    n_trials, epochs = int(cfg["sweeper"]["n_trials"]), int(cfg["trainer"]["max_epochs"])
    log(f"mnist-sweep: {' '.join(argv)} ({n_trials} trials of {epochs} epochs; cut from the config's study: "
        f"{MNIST_SWEEP_CUT or 'none'})")
    # ---- the main path: counts zeroed just before, read just after --------
    zero_kernel_launches()
    t0 = time.perf_counter()
    results = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    # ---- end of the main path ---------------------------------------------
    records = [json.loads(line) for line in journal.read_text().splitlines()]
    logs = sorted((work / "mnist-logs").rglob("metrics.csv"), key=lambda p: int(p.parent.name.split("_")[-1]))
    running_max, last_best, val_rows = [], [], []
    for path in logs:
        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        acc = [float(r["val/acc"]) for r in rows if r.get("val/acc")]
        best = [float(r["val/acc_best"]) for r in rows if r.get("val/acc_best")]
        running_max.append(best == [max(acc[: i + 1]) for i in range(len(acc))])
        last_best.append(best[-1] if best else None)
        val_rows.append(len(acc))
    best_record = max((r for r in records if r["value"] is not None), key=lambda r: r["value"], default=None)
    out = dict(card=card, seconds=seconds, trials=len(records), n_trials=n_trials, epochs=epochs,
               cut=MNIST_SWEEP_CUT, result=results, best=best_record, values=[r["value"] for r in records],
               validations_per_trial=val_rows, launches=launches)
    log("mnist-sweep " + json.dumps(out))
    if (results is None or len(results) != 1 or results[0] is None or best_record is None
            or results[0] != best_record["value"] or len(records) != n_trials
            or not all(r["value"] is not None and math.isfinite(r["value"]) for r in records)
            or len(logs) != n_trials or not all(running_max) or val_rows != [epochs] * n_trials
            or last_best != [r["value"] for r in records] or any(launches.values())):
        raise AssertionError(f"the MNIST study did not run every trial, log val/acc_best as the running max, or "
                             f"stayed off K1-K5: {out}")
    return out


# data-parallel training at he2ihc_CF_new_data's operating point (trainer=ddp: f32, 512 px, global batch 6)
DDP_OVERRIDES = TRAIN_F32_OVERRIDES + ["trainer=ddp"]
# two ranks on one card: 3 tiles a rank, 4 steps, dropout 0 so the step-1 gradient can be held against one
# process's on the same global batch (a rank's dropout masks are not one process's, ops/dropout.draw_seed);
# logger and checkpoint directories of their own, so that rank 1's can be seen to stay empty
DDP2_STEPS = 4
DDP2_OVERRIDES = DDP_OVERRIDES + ["model.net.dropout=0.0", f"trainer.limit_train_batches={DDP2_STEPS}"]
# the ZeRO run: 2 steps, the moments of every parameter whose largest dim is at least 256 sharded: 232 of
# the flagship's 276 tensors, 98.3 % of its weights (the config's fsdp_min_size 1024 shards 24 of them, 21.1 %)
FSDP_OVERRIDES = TRAIN_F32_OVERRIDES + ["trainer=fsdp", "trainer.fsdp=2", "trainer.fsdp_min_size=256",
                                        "model.net.dropout=0.0", "trainer.limit_train_batches=2", "test=false"]
DDP_FIRST_LOSS_REL_TOL = 1e-5
DDP_GRAD_REL_TOL = 1e-4  # x max|g|: two ranks' all-reduced gradient against one process's


def ddp_probe(out: str, grads: Optional[str] = None):
    """A training callback for the data-parallel phases: zeroes the kernel
    counts at fit start and reads them at fit end (the fit is the main path),
    records each step's device-synchronized end time, local loss and a float64
    checksum of the parameters, the net's forward calls and the peak memory,
    and (``grads``) saves the step-1 gradient as the optimizer sees it, after
    DDP's all-reduce. With several ranks it then times the all-reduce of one
    buffer of the net's parameter count (DDP's bucketed all-reduce a step
    moves those bytes, partly under the backward). Writes
    ``<out>.rank<r>.json``."""
    import torch

    from stain2stain_tpu_torch.training import Callback

    class DDPProbe(Callback):
        def __init__(self):
            self.ends, self.losses, self.checksums, self.forwards, self.t0 = [], [], [], [0], None

        def on_fit_start(self, trainer, task):
            task.net.register_forward_hook(lambda *_: self.forwards.__setitem__(0, self.forwards[0] + 1))
            if grads and trainer.is_global_zero:
                optimizer = getattr(trainer.state.optimizer, "optimizer", trainer.state.optimizer)

                def keep(opt, args, kwargs):
                    if trainer.state.step == 0:
                        torch.save({n: p.grad.detach().cpu() for n, p in task.net.named_parameters()}, grads)

                optimizer.register_step_pre_hook(keep)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_kernel_launches()

        def on_train_epoch_start(self, trainer, task):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, trainer, task, metrics):
            self.losses.append(float(metrics["loss"]))  # synchronizes
            self.ends.append(time.perf_counter())
            self.checksums.append(sum(float(p.detach().double().abs().sum()) for p in task.net.parameters()))

        def on_fit_end(self, trainer, task):
            torch.cuda.synchronize()
            record = dict(rank=trainer.rank, world=trainer.world_size, device=str(trainer.device),
                          backend=torch.distributed.get_backend() if torch.distributed.is_initialized() else None,
                          ddp=trainer._ddp is not None, optimizer=type(trainer.state.optimizer).__name__,
                          t0=self.t0, ends=self.ends, losses=self.losses, checksums=self.checksums,
                          forwards=self.forwards[0], launches=kernel_launches(),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
                          val_loss=trainer.callback_metrics.get("val/loss"), global_step=trainer.global_step)
            if hasattr(trainer.state.optimizer, "state_bytes"):
                record["optimizer_state_bytes"] = trainer.state.optimizer.state_bytes()
                record["sharded_params"] = len(trainer.state.optimizer.sharded())
            if trainer.world_size > 1:
                flat = torch.zeros(sum(p.numel() for p in task.net.parameters()), device=trainer.device)
                times = []
                for _ in range(3):
                    torch.distributed.barrier()
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    torch.distributed.all_reduce(flat)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - start) * 1e3)
                record["allreduce_ms"] = times
                del flat
            Path(f"{out}.rank{trainer.rank}.json").write_text(json.dumps(record))

    return DDPProbe()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _step_ms(record: dict) -> float:
    """The median step of steps 3-8 (2-4 on a shorter run) from a probe's record."""
    durations = [b - a for a, b in zip([record["t0"]] + record["ends"][:-1], record["ends"])]
    steady = durations[2:8] if len(durations) >= 8 else durations[1:]
    return statistics.median(steady) * 1e3


def _module_name() -> str:
    """This script's module name as another process imports it."""
    return "chip_smoke" if __name__ == "__main__" else __name__


def phase_train_ddp(card: str, work: Path, f32_summary: dict) -> dict:
    """``train-ddp``: ``python -m stain2stain_tpu_torch.train`` in a subprocess
    with torchrun's launch variables for a world of 1 (NCCL, the net under
    DDP) at phase 8's operating point plus ``trainer=ddp``, on a 512-px tree
    its rank 0 writes: 8 steps, validation, checkpoints, test. K1-fwd f32 with
    the lse at (96, 4096, 32) once a forward, K1-bwd once a step. Its first
    loss equals phase 8's (the same seed, data and draws; rank 0's dropout
    seeds are one process's) within 1e-5 relative."""
    data, out = work / "data-512", work / "ddp-probe"
    overrides = DDP_OVERRIDES + [f"data.data_dir={data}", f"paths.log_dir={work / 'logs'}",
                                 "extras.print_config=false", f"+callbacks.ddp_probe._target_={_module_name()}.ddp_probe",
                                 f"+callbacks.ddp_probe.out={out}"]
    env = dict(os.environ, PYTHONPATH=str(REPO), PROJECT_ROOT=str(REPO), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    log("train-ddp: " + " ".join(overrides))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stain2stain_tpu_torch.train", *overrides], cwd=work, env=env,
                          capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"train-ddp exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    record = json.loads(Path(f"{out}.rank0.json").read_text())
    first, ref = record["losses"][0], f32_summary["losses"][0]
    rel = abs(first - ref) / abs(ref)
    steps, launches = len(record["losses"]), record["launches"]
    summary = dict(card=card, wall_s=wall_s, steps=steps, world=record["world"], backend=record["backend"],
                   ddp=record["ddp"], device=record["device"], first_loss=first, first_loss_train_f32=ref,
                   first_loss_rel_diff=rel, step_ms_median_3_8=_step_ms(record),
                   train_f32_step_ms=f32_summary["step_ms_median_3_8"], peak_mem_gib=record["peak_gib"],
                   train_f32_peak_gib=f32_summary["peak_mem_gib"], forwards=record["forwards"],
                   k1_fwd_launches=launches["K1-fwd"], k1_bwd_launches=launches["K1-bwd"],
                   other_launches={k: launches[k] for k in ("K2", "K3", "K4", "K5")}, val_loss=record["val_loss"],
                   losses=record["losses"])
    log("train-ddp " + json.dumps(summary))
    if (record["world"], record["ddp"], steps) != (1, True, 8) or "nccl" not in str(record["backend"]):
        raise AssertionError(f"train-ddp did not run 8 steps under DDP in a world of 1 over NCCL: {summary}")
    if rel > DDP_FIRST_LOSS_REL_TOL:
        raise AssertionError(f"train-ddp's first loss {first} is not train-f32's {ref} (rel {rel})")
    if launches["K1-bwd"] != steps or launches["K1-fwd"] != record["forwards"] or any(summary["other_launches"].values()):
        raise AssertionError(f"train-ddp launches {launches}: K1-fwd once a forward ({record['forwards']}), "
                             f"K1-bwd once a step ({steps}), K2-K5 never")
    return summary


def ddp_worker(spec: dict) -> None:
    """One rank of ``train-ddp-2rank``: joins a gloo group of 2 itself (NCCL
    refuses two ranks on one card; gloo's all_reduce and broadcast take CUDA
    tensors), with ``LOCAL_RANK`` 0, then ``train.train(cfg)``."""
    import torch

    rank = int(spec["rank"])
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    torch.distributed.init_process_group("gloo", init_method=spec["init"], rank=rank, world_size=2)
    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.train import train

    cfg = compose(REPO / "configs", "train.yaml", spec["overrides"])
    cfg["runtime"] = {"output_dir": spec["output_dir"].replace("RANK", str(rank)), "cwd": spec["cwd"]}
    cfg["extras"]["print_config"] = False
    cfg["callbacks"]["ddp_probe"] = {"_target_": f"{_module_name()}.ddp_probe", "out": spec["out"],
                                     "grads": spec.get("grads")}
    train(cfg)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _run_pair(name: str, work: Path, overrides: list, out: Path, grads: Optional[Path] = None) -> list[dict]:
    """Two ``ddp_worker`` processes on the card; both records."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(2):
        spec = dict(rank=rank, init=init, overrides=overrides, output_dir=str(work / f"{name}-out-rankRANK"),
                    cwd=str(work), out=str(out), grads=str(grads) if grads else None)
        procs.append(subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--ddp-worker", json.dumps(spec)],
                                      cwd=work, env=dict(os.environ, PYTHONPATH=str(REPO), PROJECT_ROOT=str(REPO)),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{name} rank {rank} exited {p.returncode}:\n{text[-6000:]}")
    return [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(2)]


def phase_train_ddp_2rank(card: str, work: Path, ddp_summary: dict) -> dict:
    """``train-ddp-2rank``: two ranks share the card over gloo and train the
    flagship through ``train.train(cfg)`` at phase 8's point plus ``trainer=ddp``
    (global batch 6, 3 a rank: K1 at (48, 4096, 32)), dropout 0, 4 steps,
    validation, checkpoints, test. Both ranks' parameters are bit-identical
    after every step; the step-1 gradient is within 1e-4 x max|g| of one
    process's on the same global batch (a one-step world-1 run in this
    process); only rank 0 writes files; the last checkpoint resumes in one
    process with rank 0's weights. Then ``trainer=fsdp trainer.fsdp=2``
    (the moments sharded, ZeRO stage 1 over gloo's all_reduce) for 2 steps."""
    import torch

    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.train import train

    data, grads2 = work / "data-512", work / "grads-world2.pt"
    common = [f"data.data_dir={data}", f"callbacks.model_checkpoint.dirpath={work / 'ckpt-ddp2'}"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records = _run_pair("ddp2", work, DDP2_OVERRIDES + common, work / "ddp2-probe", grads2)
    wall_s = time.perf_counter() - t0
    stray = [str(p) for p in (work / "ddp2-out-rank1").rglob("*") if p.is_file()]
    written = [str(p.relative_to(work)) for p in (work / "ddp2-out-rank0").rglob("*") if p.is_file()]

    # one process on the same global batch: the step-1 gradient, then the 2-rank checkpoint resumed
    cfg = compose(REPO / "configs", "train.yaml", TRAIN_F32_OVERRIDES + [
        "model.net.dropout=0.0", "trainer.limit_train_batches=1", "trainer.limit_val_batches=1", "test=false",
        f"data.data_dir={data}", f"callbacks.model_checkpoint.dirpath={work / 'ckpt-world1'}"])
    cfg["runtime"] = {"output_dir": str(work / "world1-out"), "cwd": str(work)}
    cfg["extras"]["print_config"] = False
    grads1 = work / "grads-world1.pt"
    cfg["callbacks"]["ddp_probe"] = {"_target_": f"{_module_name()}.ddp_probe", "out": str(work / "world1-probe"),
                                     "grads": str(grads1)}
    _, objects = train(cfg)
    g1, g2 = torch.load(grads1), torch.load(grads2)
    gmax = max(float(g.abs().max()) for g in g1.values())
    grad_err = max(float((g2[n] - g1[n]).abs().max()) for n in g1)
    trainer, task = objects["trainer"], objects["model"]
    trainer._restore(str(work / "ckpt-ddp2" / "last"))
    resumed_checksum = sum(float(p.detach().double().abs().sum()) for p in task.net.parameters())
    resumed_step = trainer.state.step
    del objects, trainer, task
    gc.collect()
    torch.cuda.empty_cache()

    # the ZeRO run: fsdp=2 over the same two ranks
    t1 = time.perf_counter()
    fsdp = _run_pair("fsdp2", work, FSDP_OVERRIDES + [f"data.data_dir={data}",
                                                      f"callbacks.model_checkpoint.dirpath={work / 'ckpt-fsdp2'}"],
                     work / "fsdp2-probe")
    fsdp_wall_s = time.perf_counter() - t1

    r0, r1 = records
    summary = dict(
        card=card, wall_s=wall_s, steps=len(r0["losses"]), backend=r0["backend"], devices=[r0["device"], r1["device"]],
        step_ms_median=[_step_ms(r) for r in records], world1_step_ms=ddp_summary["step_ms_median_3_8"],
        peak_gib=[r["peak_gib"] for r in records], peak_reserved_gib=[r["peak_reserved_gib"] for r in records],
        checksums_equal=r0["checksums"] == r1["checksums"], checksums=r0["checksums"],
        losses=[r["losses"] for r in records], val_loss=[r["val_loss"] for r in records],
        forwards=[r["forwards"] for r in records],
        k1_fwd_launches=[r["launches"]["K1-fwd"] for r in records],
        k1_bwd_launches=[r["launches"]["K1-bwd"] for r in records],
        other_launches=[{k: r["launches"][k] for k in ("K2", "K3", "K4", "K5")} for r in records],
        grad_max_abs_err=grad_err, grad_max_abs=gmax, grad_tol=DDP_GRAD_REL_TOL * gmax,
        allreduce_ms=[r["allreduce_ms"] for r in records],
        allreduce_share=[statistics.median(r["allreduce_ms"]) / _step_ms(r) for r in records],
        rank1_files=stray, rank0_files=len(written), resumed_step=resumed_step,
        resumed_checksum=resumed_checksum, rank0_final_checksum=r0["checksums"][-1],
        fsdp=dict(wall_s=fsdp_wall_s, steps=[len(r["losses"]) for r in fsdp], step_ms=[_step_ms(r) for r in fsdp],
                  checksums_equal=fsdp[0]["checksums"] == fsdp[1]["checksums"], optimizer=fsdp[0]["optimizer"],
                  state_bytes=[r.get("optimizer_state_bytes") for r in fsdp],
                  sharded_params=fsdp[0].get("sharded_params"), peak_gib=[r["peak_gib"] for r in fsdp],
                  k1_fwd_launches=[r["launches"]["K1-fwd"] for r in fsdp],
                  k1_bwd_launches=[r["launches"]["K1-bwd"] for r in fsdp]),
    )
    log("train-ddp-2rank " + json.dumps(summary))
    if summary["steps"] != DDP2_STEPS or not summary["checksums_equal"] or r0["backend"] != "gloo":
        raise AssertionError(f"the two ranks did not run {DDP2_STEPS} gloo steps with equal parameters: {summary}")
    if grad_err > summary["grad_tol"]:
        raise AssertionError(f"the 2-rank step-1 gradient is {grad_err} from one process's (tol {summary['grad_tol']})")
    if stray or not written:
        raise AssertionError(f"rank 1 wrote {stray}, or rank 0 wrote nothing")
    if resumed_step != DDP2_STEPS or resumed_checksum != summary["rank0_final_checksum"]:
        raise AssertionError("the 2-rank checkpoint does not resume in one process with rank 0's weights")
    for r in records:
        if (r["launches"]["K1-bwd"] != len(r["losses"]) or r["launches"]["K1-fwd"] != r["forwards"]
                or any(r["launches"][k] for k in ("K2", "K3", "K4", "K5"))):
            raise AssertionError(f"rank {r['rank']} launches {r['launches']}: K1-fwd once a forward, "
                                 "K1-bwd once a step, K2-K5 never")
    f = summary["fsdp"]
    if f["steps"] != [2, 2] or not f["checksums_equal"] or f["optimizer"] != "ShardedOptimizer" or not f["sharded_params"]:
        raise AssertionError(f"the fsdp=2 run did not take 2 equal sharded steps: {f}")
    return summary


def phase_dropout_bits(card: str) -> dict:
    """``dropout-bits``: ``FastDropout(0.1, impl="bits")`` on a (32, 128,
    256, 256) bf16 tensor on the card, backward with dy = 1 (so ``x.grad`` is
    the backward's mask): the mask's values are {0, bf16(1/0.9)}, its keep
    fraction within 5σ of 0.9, y = x · mask bit for bit (the forward's mask
    is the backward's), and the same generator state gives the same output.
    Times of the forward beside ``hash_dropout``'s on the same tensor."""
    import torch

    from stain2stain_tpu_torch.ops.dropout import FastDropout, draw_seed, hardware_dropout, hash_dropout

    rate = 0.1
    x = torch.randn(32, 128, 256, 256, device="cuda", generator=torch.Generator("cuda").manual_seed(0),
                    dtype=torch.bfloat16).requires_grad_()
    drop = FastDropout(rate, impl="bits").train()
    y = drop(x, torch.Generator().manual_seed(11))
    y.backward(torch.ones_like(y))
    mask = x.grad
    values = sorted(torch.unique(mask.float()).tolist())
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.bfloat16).item()
    n = mask.numel()
    kept = float((mask != 0).double().mean())
    sigma = math.sqrt(rate * (1 - rate) / n)
    same_mask = torch.equal(y, x.detach() * mask)
    again = torch.equal(y, drop(x.detach(), torch.Generator().manual_seed(11)))
    other = not torch.equal(y, drop(x.detach(), torch.Generator().manual_seed(12)))
    seed = draw_seed(torch.Generator().manual_seed(11))
    xd = x.detach()
    del y, mask
    x.grad = None
    with torch.no_grad():
        bits_ms = cuda_ms(lambda: hardware_dropout(xd, seed, rate), repeats=10)
        hash_ms = cuda_ms(lambda: hash_dropout(xd, seed, rate), repeats=10)
    out = dict(card=card, shape=list(x.shape), dtype="bfloat16", rate=rate, values=values, scale=scale,
               keep_fraction=kept, sigma=sigma, keep_dev_sigmas=abs(kept - (1 - rate)) / sigma,
               forward_mask_is_backward_mask=same_mask, same_generator_same_mask=again,
               other_generator_other_mask=other, bits_ms=bits_ms, hash_ms=hash_ms)
    log("dropout-bits " + json.dumps(out))
    if (values != [0.0, scale] or abs(kept - (1 - rate)) > 5 * sigma or not (same_mask and again and other)):
        raise AssertionError(f"the bits dropout mask is wrong: {out}")
    return out


# the mask net's dropout shapes at 512 px, batch 8 (NCHW) and their ResBlocks: 22 dropout layers a forward
MASK_DROPOUT_SHAPES = (((8, 128, 512, 512), 5), ((8, 256, 256, 256), 5), ((8, 256, 128, 128), 5),
                       ((8, 512, 64, 64), 7))


def same_bits(a, b) -> bool:
    """Equal bit for bit (signed zeros included), NaN where the other is NaN."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}[a.dtype]
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a.view(ints)[~nan], b.view(ints)[~nan]))


def max_abs_diff(a, b) -> float:
    """The largest |a - b| in float32: 0 where both are NaN or equal (infinities
    too), infinity where only one is NaN."""
    import torch

    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    diff = torch.nan_to_num(torch.where(same, 0.0, (a - b).abs()), nan=math.inf)
    return float(diff.max()) if diff.numel() else 0.0


def phase_dropout_kernel(card: str) -> dict:
    """``dropout-kernel``: ``hash_dropout`` on the card (``csrc/dropout.cu``)
    against the plain ``x * hash_mask(...)``, forward and gradient
    (``torch.autograd.grad`` with a random dy), bit for bit: the mask net's
    four dropout shapes, an odd shape (2, 6, 5, 7) whose planes take no
    vectors (with -0, ±inf and NaN in x), a non-contiguous input; float32,
    bfloat16 and float16; seeds 0, 12345, 2^31+7 and 2^32-1; rates 0.1 and
    0.5. One launch a forward and one a backward. Then times of the kernel
    (``ms`` and ``queued_ms``) against the plain chain at each mask shape in
    float32, with the bound (a read and a write of x at 3.35 TB/s), and the
    kernel's device milliseconds a mask step (44 calls)."""
    import torch

    from stain2stain_tpu_torch.ops.dropout import hash_dropout, hash_mask

    gen = torch.Generator(device="cuda").manual_seed(0)
    odd = torch.randn(2, 6, 5, 7, device="cuda", generator=gen)
    odd.view(-1)[:5] = torch.tensor([-0.0, float("inf"), float("-inf"), float("nan"), 0.0])
    inputs = [(list(shape), "contiguous", torch.randn(shape, device="cuda", generator=gen))
              for shape, _ in MASK_DROPOUT_SHAPES]
    inputs += [([2, 6, 5, 7], "odd shape, special values", odd),
               ([2, 64, 96, 80], "non-contiguous (a transposed view)",
                torch.randn(2, 64, 80, 96, device="cuda", generator=gen).transpose(2, 3))]
    cases, bad = [], []
    before = hash_dropout.launches
    calls, max_abs_err = 0, 0.0
    for shape, what, base in inputs:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            x = base.to(dtype).detach().requires_grad_()  # keeps the view's strides
            dy = torch.empty_like(x).copy_(torch.randn(x.shape, device="cuda", generator=gen))
            for seed in (0, 12345, 2**31 + 7, 2**32 - 1):
                for rate in (0.1, 0.5):
                    y = hash_dropout(x, seed, rate)
                    (dx,) = torch.autograd.grad(y, x, dy)
                    calls += 2
                    with torch.no_grad():
                        mask = hash_mask(seed, tuple(x.shape), rate, dtype, "cuda")
                        ok = same_bits(y, x * mask) and same_bits(dx, dy * mask)
                        err = max(max_abs_diff(y, x * mask), max_abs_diff(dx, dy * mask))
                    max_abs_err = max(max_abs_err, err)
                    row = dict(shape=shape, what=what, dtype=str(dtype).split(".")[-1], seed=seed, rate=rate,
                               contiguous_input=x.is_contiguous(), bit_identical=ok, max_abs_err=err)
                    cases.append(row)
                    if not ok:
                        bad.append(row)
                    del y, dx, mask
            del x, dy
        torch.cuda.empty_cache()
    launches = hash_dropout.launches - before
    log("dropout-kernel-checks " + json.dumps({"cases": len(cases), "bad": bad, "launches": launches,
                                                "calls": calls, "max_abs_err": max_abs_err}))

    timings, step_ms = [], 0.0
    seed, rate = 2**31 + 7, 0.1
    for shape, blocks in MASK_DROPOUT_SHAPES:
        x = torch.randn(shape, device="cuda", generator=gen)
        with torch.no_grad():
            ms = cuda_ms(lambda: hash_dropout(x, seed, rate), repeats=20)
            queued_ms = cuda_queued_ms(lambda: hash_dropout(x, seed, rate))
            plain_ms = cuda_ms(lambda: x * hash_mask(seed, shape, rate, x.dtype, "cuda"), repeats=5)
            plain_queued_ms = cuda_queued_ms(lambda: x * hash_mask(seed, shape, rate, x.dtype, "cuda"), calls=5)
        bound_ms = 2 * x.numel() * x.element_size() / PEAK_BYTES_PER_S * 1e3
        row = dict(card=card, shape=list(shape), dtype="float32", blocks=blocks, ms=ms, queued_ms=queued_ms,
                   plain_ms=plain_ms, plain_queued_ms=plain_queued_ms, bound_ms=bound_ms, bound_by="bytes",
                   bandwidth_share=bound_ms / queued_ms)
        log("dropout-kernel " + json.dumps(row))
        timings.append(row)
        step_ms += 2 * blocks * queued_ms  # each layer's forward and backward
        del x
        torch.cuda.empty_cache()
    out = dict(card=card, cases=len(cases), bad=bad, launches=launches, calls=calls, max_abs_err=max_abs_err,
               timings=timings, step_ms=step_ms)
    log("dropout-kernel-step " + json.dumps({"calls_a_step": 2 * sum(b for _, b in MASK_DROPOUT_SHAPES),
                                             "queued_ms_a_step": step_ms}))
    if bad or launches != calls:
        raise AssertionError(f"the dropout kernel is not the plain product bit for bit, or launched {launches} "
                             f"times for {calls} calls: {bad}")
    return out


# the LayerNorm-modulate kernels' checks: (what, (B, T, C), x dtype, scale/shift dtype, y dtype, peaked rows)
LN_MODULATE_CASES = (
    ("DiT-XL/2 training shape: f32 x, the adaLN layer's bf16 chunks, bf16 y", (32, 1024, 1152), "float32", "bfloat16",
     "bfloat16", False),
    ("f32 throughout, odd T: a ragged last backward block", (4, 257, 1152), "float32", "float32", "float32", False),
    ("DiT-S width, bf16 x", (2, 64, 384), "bfloat16", "bfloat16", "bfloat16", False),
    ("peaked rows: one value of 1000 a row", (4, 64, 1152), "float32", "bfloat16", "bfloat16", True),
)
LN_MODULATE_SHAPE = (32, 1024, 1152)  # the DiT-XL/2 cell's: batch 32, T 1024, hidden 1152
LN_MODULATE_CALLS = 57  # a DiT-XL/2 step: 2 a block x 28 + the final layer's
# largest error against the plain chain in f32: relative norm where the output is
# f32; where it is bf16, one bf16 step of the f32 value plus this share of its
# largest magnitude (the f32 arithmetic's own rounding, which near 0 exceeds a step)
LN_MODULATE_TOL = {"y": 1e-6, "grad": 1e-5}


def _bf16_steps_over(got, want, atol: float) -> float:
    """max(|got - want| - atol) in bf16 steps of ``want`` (2^(exponent - 8)): at
    most 1 when ``got`` lies within one step of ``want`` beyond ``atol``."""
    import torch

    want = want.float()
    step = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    over = ((got.float() - want).abs() - atol).clamp(min=0)
    return float(torch.where(over == 0, 0.0, over / step.clamp(min=2.0**-133)).max())


def ln_modulate_case(shape, x_dtype: str, param_dtype: str, y_dtype: str, peaked: bool, seed: int = 0) -> dict:
    """``layer_norm_modulate`` on the card (the kernels) against the plain chain
    (``norms._LayerNormModulate``) in f32 on the same values, forward and every
    gradient, with scale and shift as the DiT passes them (two (B, C) chunks of
    a (B, 6C) adaLN output); twice, bit for bit; one launch of each kernel a call."""
    import torch

    from stain2stain_tpu_torch.ops import norms

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, t, c = shape
    x = torch.randn(shape, device="cuda", generator=gen) * 3 + 1
    if peaked:
        x[:, :, 7] = 1000.0
    x = x.to(dt[x_dtype])
    scale, shift = (torch.randn(b, 6 * c, device="cuda", generator=gen) * 0.5).to(dt[param_dtype]).chunk(6, dim=1)[:2]
    dy = torch.randn(shape, device="cuda", generator=gen).to(dt[y_dtype])
    before = (norms.ln_modulate_fwd.launches, norms.ln_modulate_bwd.launches)
    runs = []
    for _ in range(2):
        leaves = [a.detach().requires_grad_() for a in (x, scale, shift)]
        y = norms.layer_norm_modulate(*leaves, dtype=dt[y_dtype])
        runs.append((y.detach(), *torch.autograd.grad(y, leaves, dy)))
    launched = [norms.ln_modulate_fwd.launches - before[0], norms.ln_modulate_bwd.launches - before[1]]
    leaves = [a.detach().float().requires_grad_() for a in (x, scale, shift)]
    y = norms._LayerNormModulate.apply(*leaves, 1e-6, torch.float32)
    ref = (y.detach(), *torch.autograd.grad(y, leaves, dy.float()))
    errors, ok = {}, True
    for name, got, want in zip(("y", "dx", "dscale", "dshift"), runs[0], ref):
        tol = LN_MODULATE_TOL["y" if name == "y" else "grad"]
        rel = float((got.float() - want).norm() / want.norm())
        errors[name] = {"dtype": str(got.dtype).split(".")[-1], "rel_norm": rel, "max_abs": max_abs_diff(got, want)}
        if got.dtype == torch.float32:
            ok &= rel <= tol
        else:
            errors[name]["bf16_steps"] = _bf16_steps_over(got, want, tol * float(want.abs().max()))
            ok &= errors[name]["bf16_steps"] <= 1.0
    identical = all(same_bits(a, b) for a, b in zip(*runs))
    ok &= identical and launched == [2, 2]
    return dict(shape=list(shape), x=x_dtype, params=param_dtype, y=y_dtype, peaked=peaked, errors=errors,
                bit_identical=identical, launches=launched, ok=ok)


def phase_ln_modulate_kernel(card: str) -> dict:
    """``ln-modulate-kernel``: the DiT's LayerNorm-modulate kernels
    (``csrc/layer_norm_modulate.cu``) against the plain chain at the cases of
    ``LN_MODULATE_CASES`` (:func:`ln_modulate_case`); a ``ValueError`` for C not
    a multiple of 8 and for float64 on the card, with nothing launched. Then at
    the DiT cell's shape (f32 x, bf16 chunks, bf16 y): each kernel's ``ms`` and
    ``queued_ms`` against its bound (forward: x read, y written; backward: dy
    and x read, dx written) and against the plain chain's forward and backward
    and torch's ``F.layer_norm`` chain, the pair as a training step calls it
    (through autograd), and the pair's queued milliseconds a DiT-XL/2 step."""
    import types

    import torch
    import torch.nn.functional as F

    from stain2stain_tpu_torch.ops import norms

    cases = []
    for what, *args in LN_MODULATE_CASES:
        cases.append(dict(what=what, **ln_modulate_case(*args)))
        log("ln-modulate-case " + json.dumps(cases[-1]))
        torch.cuda.empty_cache()
    refused = []
    before = (norms.ln_modulate_fwd.launches, norms.ln_modulate_bwd.launches)
    for what, (x, p) in (("C 20", (torch.zeros(2, 4, 20, device="cuda"), torch.zeros(2, 20, device="cuda"))),
                         ("float64", (torch.zeros(2, 4, 16, device="cuda", dtype=torch.float64),
                                      torch.zeros(2, 16, device="cuda", dtype=torch.float64)))):
        try:
            norms.layer_norm_modulate(x, p, p)
        except ValueError as e:
            refused.append(f"{what}: {e}")
    refused_ok = len(refused) == 2 and before == (norms.ln_modulate_fwd.launches, norms.ln_modulate_bwd.launches)
    log("ln-modulate-refused " + json.dumps(refused))

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, t, c = LN_MODULATE_SHAPE
    n = b * t * c
    x = (torch.randn(LN_MODULATE_SHAPE, device="cuda", generator=gen) * 3 + 1).requires_grad_()
    ada = (torch.randn(b, 6 * c, device="cuda", generator=gen) * 0.5).to(bf16).requires_grad_()
    dy = torch.randn(LN_MODULATE_SHAPE, device="cuda", generator=gen).to(bf16)

    def chunks():
        return ada.chunk(6, dim=1)[:2]

    def pair(op):
        scale, shift = chunks()
        torch.autograd.grad(op(x, scale, shift), (x, ada), dy)

    kernel = lambda x, s, h: norms.layer_norm_modulate(x, s, h, dtype=bf16)  # noqa: E731
    plain = lambda x, s, h: norms._LayerNormModulate.apply(x, s, h, 1e-6, bf16)  # noqa: E731
    library = lambda x, s, h: (F.layer_norm(x, (c,), eps=1e-6) * (1 + s.float()[:, None])  # noqa: E731
                               + h.float()[:, None]).to(bf16)
    scale, shift = (p.detach() for p in chunks())
    xd = x.detach()
    _, mean, rstd = norms.ln_modulate_fwd(xd, scale, shift, 1e-6, bf16)
    plain_ctx = types.SimpleNamespace(saved_tensors=(xd, scale, mean[..., None], rstd[..., None]), shift_dtype=bf16)
    with torch.no_grad():
        fwd = dict(ms=cuda_ms(lambda: norms.ln_modulate_fwd(xd, scale, shift, 1e-6, bf16), repeats=20),
                   queued_ms=cuda_queued_ms(lambda: norms.ln_modulate_fwd(xd, scale, shift, 1e-6, bf16)),
                   plain_queued_ms=cuda_queued_ms(lambda: plain(xd, scale, shift), calls=5),
                   library_queued_ms=cuda_queued_ms(lambda: library(xd, scale, shift), calls=5),
                   bound_ms=6 * n / PEAK_BYTES_PER_S * 1e3)
        bwd = dict(ms=cuda_ms(lambda: norms.ln_modulate_bwd(xd, dy, scale, mean, rstd, bf16), repeats=20),
                   queued_ms=cuda_queued_ms(lambda: norms.ln_modulate_bwd(xd, dy, scale, mean, rstd, bf16)),
                   plain_queued_ms=cuda_queued_ms(lambda: norms._LayerNormModulate.backward(plain_ctx, dy), calls=5),
                   bound_ms=10 * n / PEAK_BYTES_PER_S * 1e3)
    both = dict(ms=cuda_ms(lambda: pair(kernel), repeats=20), queued_ms=cuda_queued_ms(lambda: pair(kernel)),
                plain_ms=cuda_ms(lambda: pair(plain), repeats=5), plain_queued_ms=cuda_queued_ms(lambda: pair(plain), calls=5),
                library_ms=cuda_ms(lambda: pair(library), repeats=5),
                library_queued_ms=cuda_queued_ms(lambda: pair(library), calls=5),
                bound_ms=16 * n / PEAK_BYTES_PER_S * 1e3)
    for row in (fwd, bwd, both):
        row["bandwidth_share"] = row["bound_ms"] / row["queued_ms"]
    step = {k: LN_MODULATE_CALLS * both[k] for k in ("queued_ms", "plain_queued_ms", "library_queued_ms", "bound_ms")}
    out = dict(card=card, shape=list(LN_MODULATE_SHAPE), dtype="float32 x, bfloat16 scale/shift/y", fwd=fwd, bwd=bwd,
               pair=both, step_ms=step, cases=cases, refused=refused,
               max_abs_err=max(e["max_abs"] for cs in cases for e in cs["errors"].values()))
    log("ln-modulate-kernel " + json.dumps({k: v for k, v in out.items() if k != "cases"}))
    bad = [cs for cs in cases if not cs["ok"]]
    if bad or not refused_ok:
        raise AssertionError(f"the LayerNorm-modulate kernels are not the plain chain, not deterministic, or did not "
                             f"launch once a call, or took what they must refuse ({refused}): {bad}")
    return out


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def phase_profile(net, card: str) -> dict:
    """Where the time of one tile batch goes (``--profile`` only).

    ``torch.profiler`` over three 2-step euler generate calls on a batch of 16
    256-px tiles (the server's shape): device time by kernel, the device's
    busy share of the wall time, and the host's share of a whole request.
    """
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stain2stain_tpu_torch.ops.image import denormalize_np, normalize_uint8_np
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule
    from stain2stain_tpu_torch.wsi import make_tiled_generator, translate_large_image

    torch.backends.cudnn.allow_tf32 = True  # the serving defaults again
    torch.backends.cuda.matmul.allow_tf32 = False
    task = ConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler"))
    gen = make_tiled_generator(task, num_steps=2)
    batch = np.stack([_test_image(256, 256, seed=200 + i) for i in range(16)]).astype(np.float32) / 127.5 - 1.0
    gen(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            gen(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies); the aten ops that launch them
    # would count the same time twice
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    rows = [dict(kernel=e.key[:90], device_ms=_device_us(e) / 1e3 / 3, calls=e.count / 3,
                 share=_device_us(e) / busy_us if busy_us else 0.0) for e in top]
    for r in rows:
        log("profile-kernel " + json.dumps(r))

    # host vs device for a whole request: time inside generate vs the request
    spent = [0.0]

    def timed(b):
        t = time.perf_counter()
        out = gen(b)
        spent[0] += time.perf_counter() - t
        return out

    t1 = time.perf_counter()
    out01 = denormalize_np(translate_large_image(
        timed, normalize_uint8_np(_test_image(1000, 900, seed=7)), tile=256, overlap=32, batch_size=16
    ))
    request_s = time.perf_counter() - t1
    if not np.isfinite(out01).all():
        raise AssertionError("profiled request returned non-finite pixels")
    result = dict(card=card, per_batch_wall_ms=wall_us / 1e3 / 3, per_batch_device_busy_ms=busy_us / 1e3 / 3,
               device_idle_share=max(0.0, 1.0 - busy_us / wall_us) if wall_us else None,
               request_s=request_s, request_generate_s=spent[0],
               request_host_share=1.0 - spent[0] / request_s)
    log("profile " + json.dumps(result))
    return result


# torch's own GroupNorm and BatchNorm kernels (the multitask nets'; the UNet's
# norms are the port's reductions and elementwise passes)
_NORM_KERNELS = ("GroupNorm", "RowwiseMoments", "ComputeFusedParams", "ComputeInternalGradients",
                 "ComputeBackwardFusedParams", "GammaBetaBackward", "batch_norm", "BatchNorm", "bn_fw", "bn_bw")


def _train_kernel_category(name: str) -> str:
    """A device kernel's layer, from its name."""
    if any(s in name for s in ("conv3x3_fwd_kernel", "prologue_grad", "conv3x3_wgrad_kernel", "wgrad_reduce")):
        return "fused conv K2-K5"
    if "attention_fwd" in name:
        return "attention forward K1-fwd"
    if "attention_bwd" in name:
        return "attention backward K1-bwd"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "cuDNN layout transposes"
    if any(s in name for s in _NORM_KERNELS):
        return "GroupNorm / BatchNorm kernels"
    if "upsample_bilinear" in name:
        return "bilinear resizes"
    if "max_pool" in name:
        return "max pooling"
    if any(s in name for s in ("xmma", "gemm", "conv", "wgrad", "dgrad", "cutlass", "cudnn")):
        return "convolutions and matmuls"
    if "<int" in name:
        return "int32 elementwise (dropout hash)"
    if "reduce_kernel" in name:
        return "reductions (norm statistics, sums)"
    if "copy" in name or "Cat" in name:
        return "copies and casts"
    return "other elementwise"


# each profiled train step: (overrides, batch, pixels, trainer precision)
PROFILED_STEPS = {
    "profile-train": (["experiment=quality_synthetic_256", "trainer.accelerator=gpu"], 32, 256, "bf16-mixed"),
    "profile-train-fused": (["experiment=quality_synthetic_256", "trainer.accelerator=gpu", FUSED_OVERRIDE], 32, 256,
                            "bf16-mixed"),
    "profile-train-f32": (["experiment=quality_synthetic_256", "trainer.accelerator=gpu", "trainer.precision=32"], 6,
                          512, 32),
    "profile-train-multitask": (["experiment=multitask_he2ihc_amyloid", "trainer.accelerator=gpu"] + BATCH_NORM,
                                MULTITASK_BATCH, 512, 32),
    "profile-train-multitask-group": (["experiment=multitask_he2ihc_amyloid", "trainer.accelerator=gpu"],
                                      MULTITASK_BATCH, 512, 32),
}


def phase_profile_train(card: str, name: str = "profile-train") -> dict:
    """Where the time of one train step goes (``--profile`` only).

    The flagship task of ``PROFILED_STEPS[name]``: batch 32, 256 px,
    bf16-mixed, unfused or with ``+model.net.fused_conv=true``; or batch 6,
    512 px, f32; or the binary multitask study (batch 16, 512 px, f32, a
    random binary mask) under BatchNorm or the configs' GroupNorm. Through
    the trainer's own step (augmentation, loss,
    backward, Adam), under ``torch.profiler`` for three steps after two
    warm-up steps: device time by kernel, the device's busy share of the wall
    time, and each kernel category's share.
    """
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.training import Trainer
    from stain2stain_tpu_torch.utils.utils import instantiate_task

    torch.backends.cudnn.allow_tf32 = True  # torch's defaults for training
    torch.backends.cuda.matmul.allow_tf32 = False
    overrides, batch_size, px, precision = PROFILED_STEPS[name]
    cfg = compose(REPO / "configs", "train.yaml", overrides)
    torch.manual_seed(0)
    task = instantiate_task(cfg.model, device="cuda")
    trainer = Trainer(accelerator="gpu", precision=precision, logger=False)
    trainer._prepare_task(task)
    trainer._init_state(task)
    rng = np.random.default_rng(0)
    shapes = {"image": (batch_size, px, px, 3), "mask": (batch_size, px, px)}
    batch = tuple(torch.from_numpy(rng.integers(0, 256 if kind == "image" else 2, shapes[kind], dtype=np.uint8)).cuda()
                  for kind in task.device_fields(task.batch_fields))
    augment = {"crop_size": px, "hflip": True, "vflip": True}
    for _ in range(2):
        trainer._train_step(task, batch, augment)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._train_step(task, batch, augment)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    rows = [dict(kernel=e.key[:90], device_ms=_device_us(e) / 1e3 / steps, calls=e.count / steps,
                 share=_device_us(e) / busy_us) for e in top]
    for r in rows:
        log(f"{name}-kernel " + json.dumps(r))
    # every kernel of the port, in or out of the top rows: its device ms a step
    ours = {e.key[:60]: dict(device_ms=_device_us(e) / 1e3 / steps, calls=e.count / steps) for e in kernels
            if _train_kernel_category(e.key) in ("fused conv K2-K5", "attention forward K1-fwd",
                                                 "attention backward K1-bwd")}
    log(f"{name}-port-kernels " + json.dumps(ours))
    shares: dict[str, float] = {}
    for e in kernels:
        category = _train_kernel_category(e.key)
        shares[category] = shares.get(category, 0.0) + _device_us(e) / busy_us
    result = dict(card=card, batch=batch_size, px=px, precision=precision, steps=steps,
                  per_step_wall_ms=wall_us / 1e3 / steps,
                  per_step_device_busy_ms=busy_us / 1e3 / steps,
                  device_idle_share=max(0.0, 1.0 - busy_us / wall_us),
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                  shares_of_busy_time=dict(sorted(shares.items(), key=lambda kv: -kv[1])))
    log(f"{name} " + json.dumps(result))
    del task, trainer, batch, prof
    torch.cuda.empty_cache()
    return result


# ------------------------------------------------------------------ phases 29-32
# the loaded program against the direct generate on the same card and inputs: the same kernels and ops in the
# same order, so bit for bit is the aim; dopri5's accept/reject compares norms, so 1e-5 over its whole solve
SEALED_TOL = {"euler": 1e-6, "dopri5": 1e-5, "fused": 1e-6}
SEALED_BATCH, SEALED_SIZE = 16, 256
S2B_FIRST_LOSS_REL_TOL = 1e-5
SANITY_TILES = (64, 16, 16)  # train / val / test 256-px tiles with binary masks


def counted_calls(fn, repeats: int) -> tuple:
    """``1 + repeats`` calls of ``fn`` each bracketed by CUDA events, the
    launch counts zeroed just before the first and read just after it:
    (its output, its launches, the median ms of all)."""
    import torch

    times, out, launches = [], None, None
    for i in range(1 + repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if i == 0:
            zero_kernel_launches()
        start.record()
        result = fn()
        end.record()
        end.synchronize()
        if i == 0:
            out, launches = result, kernel_launches()
        times.append(start.elapsed_time(end))
    return out, launches, statistics.median(times)


def sealed_worker(spec: dict) -> None:
    """Loaded sealed programs in a process of their own, which imports the
    port's ``serving`` module and nothing of its models or tasks: for each
    program the load time, the first call, then :func:`counted_calls`; its
    output to ``<program>.out.npy``, the records to ``spec["result"]``."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.serving import load_generator

    src = torch.from_numpy(np.load(spec["source"])).cuda()
    records = {}
    for name, program, repeats in spec["programs"]:
        t0 = time.perf_counter()
        call = load_generator(program)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        call(src)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        out, launches, ms = counted_calls(lambda: call(src), repeats)
        np.save(program + ".out.npy", out.cpu().numpy())
        records[name] = dict(load_s=load_s, first_call_s=first_s, ms=ms, launches=launches)
        del call, out
        torch.cuda.empty_cache()
    loaded = sorted(m for m in sys.modules if m.startswith(("stain2stain_tpu_torch.models", "stain2stain_tpu_torch.tasks",
                                                            "stain2stain_tpu_torch.config", "stain2stain_tpu.")))
    Path(spec["result"]).write_text(json.dumps(dict(records=records, model_modules=loaded)))


def run_sealed(programs: list, source: Path, work: Path) -> dict:
    """:func:`sealed_worker` on ``programs`` ((name, path, repeats)) in one
    subprocess: {name: (its record, its output)}."""
    import numpy as np

    spec = dict(programs=[(n, str(p), r) for n, p, r in programs], source=str(source),
                result=str(work / "sealed-result.json"))
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--sealed-worker", json.dumps(spec)],
                          cwd=work, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the sealed programs failed in their process:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    result = json.loads(Path(spec["result"]).read_text())
    if result["model_modules"]:
        raise AssertionError(f"loading the sealed programs imported model code: {result['model_modules']}")
    return {n: (result["records"][n], np.load(str(p) + ".out.npy")) for n, p, _ in programs}


def phase_serve_sealed(card: str, net, work: Path) -> dict:
    """``serve-sealed``: phase 5's jittered flagship sealed for batch 16 at 256
    px by ``serving.export_generator`` (euler with 2 steps, the config's
    dopri5, and a bf16 ``fused_conv`` net with the same weights under euler),
    the programs loaded and run on the tile batch in a process of their own
    (:func:`sealed_worker`): within ``SEALED_TOL`` of the direct
    ``generate``, with the same K1-fwd (and K2) launches; the export seconds,
    the program's MB, the loaded and direct tile-batch ms."""
    import numpy as np
    import torch

    from stain2stain_tpu_torch.config import compose, instantiate
    from stain2stain_tpu_torch.ops.solvers import SolverConfig
    from stain2stain_tpu_torch.serving import export_generator
    from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule

    torch.backends.cuda.matmul.allow_tf32 = False  # torch's defaults, as the loading process has them
    torch.backends.cudnn.allow_tf32 = True
    cfg = compose(REPO / "configs", "infer.yaml", ["model=conditional_flow_matching"])
    fused_cfg = compose(REPO / "configs", "infer.yaml", ["model=conditional_flow_matching", FUSED_OVERRIDE])
    fused_net = instantiate(fused_cfg.model.net, device="cuda")
    fused_net.load_state_dict(net.state_dict())
    fused_net.dtype = torch.bfloat16
    evals = [0]
    hooks = [m.register_forward_hook(lambda *_: evals.__setitem__(0, evals[0] + 1)) for m in (net, fused_net)]
    cases = {  # name: (task, num_steps, timed calls after the counted one)
        "euler": (ConditionalFlowMatchingModule(net=net, solver=SolverConfig("euler")), 2, 4),
        "dopri5": (ConditionalFlowMatchingModule(net=net, solver=instantiate(cfg.model.solver)), 100, 0),
        "fused": (ConditionalFlowMatchingModule(net=fused_net, solver=SolverConfig("euler")), 2, 4),
    }
    src = tile_batch(SEALED_BATCH, SEALED_SIZE)
    source = work / "sealed-source.npy"
    np.save(source, src.cpu().numpy())
    results, direct = {}, {}
    for name, (task, num_steps, repeats) in cases.items():
        # the direct path, counts zeroed just before and read just after its first call
        evals[0] = 0
        out, launches, ms = counted_calls(lambda: task.generate(src, num_steps=num_steps), repeats)
        direct[name], velocity_evals = out, evals[0] // (1 + repeats)  # read before the export traces the net
        program = work / f"sealed-{name}.pt2"
        t0 = time.perf_counter()
        export_generator(task, program, batch=SEALED_BATCH, image_size=SEALED_SIZE, num_steps=num_steps)
        results[name] = dict(card=card, num_steps=num_steps, repeats=repeats, export_s=time.perf_counter() - t0,
                             program_mb=program.stat().st_size / 1e6, direct_ms=ms, direct_launches=launches,
                             velocity_evals=velocity_evals,
                             sidecar=json.loads(Path(str(program) + ".json").read_text()))
    for h in hooks:
        h.remove()
    del fused_net, cases
    # the loaded programs' main path, in their process
    loaded = run_sealed([(n, work / f"sealed-{n}.pt2", r["repeats"]) for n, r in results.items()], source, work)
    for name, r in results.items():
        record, out = loaded[name]
        err = float(np.abs(out - direct[name].cpu().numpy()).max())
        r.update(load_s=record["load_s"], first_call_s=record["first_call_s"], loaded_ms=record["ms"],
                 loaded_launches=record["launches"], max_abs_err=err, bit_equal=bool(err == 0.0))
        log(f"serve-sealed-{name} " + json.dumps(r))
        if not np.isfinite(out).all() or out.shape != tuple(src.shape) or err > SEALED_TOL[name]:
            raise AssertionError(f"the sealed {name} program differs from generate by {err} (tolerance "
                                 f"{SEALED_TOL[name]}) or is non-finite/misshapen")
        k1, k2 = r["loaded_launches"]["K1-fwd"], r["loaded_launches"]["K2"]
        if k1 == 0 or k1 != r["direct_launches"]["K1-fwd"] or k1 != r["velocity_evals"]:
            raise AssertionError(f"{name}: K1-fwd launches loaded {k1}, direct {r['direct_launches']['K1-fwd']}, "
                                 f"velocity evaluations {r['velocity_evals']}")
        want_k2 = FLAGSHIP_FUSED_CONVS * r["velocity_evals"] if name == "fused" else 0
        if k2 != r["direct_launches"]["K2"] or k2 != want_k2:
            raise AssertionError(f"{name}: K2 launches loaded {k2}, direct {r['direct_launches']['K2']}, "
                                 f"want {want_k2}")
        if r["sidecar"]["platforms"] != ["cuda"] or r["sidecar"]["batch"] != SEALED_BATCH:
            raise AssertionError(f"{name}: sidecar {r['sidecar']}")
    return dict(results=results, euler_direct=direct["euler"], euler_program=work / "sealed-euler.pt2", src=src)


def _archive_members(path: Path) -> dict:
    """{member name without the archive's top folder: bytes} of a ``.pt2``."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {name.split("/", 1)[1]: z.read(name) for name in z.namelist()}


def phase_convert_ckpt(card: str, net, work: Path, sealed: dict) -> dict:
    """``convert-ckpt``: a Lightning-layout ``.ckpt`` of phase 5's jittered
    flagship (``{"state_dict": {"net." + k: v}, "epoch", "global_step"}``)
    through ``python -m stain2stain_tpu_torch.convert_ckpt``; ``load_task`` on
    the directory generates phase 29's tile batch (euler, 2 steps) bit for bit
    as the source task did, with one K1-fwd launch; ``export_model`` on the
    directory writes phase 29's euler program: every member of the archive
    (graph, weights, constants) the same bytes."""
    import torch

    from stain2stain_tpu_torch import convert_ckpt, export_model
    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.inference import load_task

    ckpt = work / "flagship.ckpt"
    torch.save({"state_dict": {f"net.{k}": v.cpu() for k, v in net.state_dict().items()}, "epoch": 3,
                "global_step": 24}, ckpt)
    out_dir = work / "converted"
    t0 = time.perf_counter()
    _cli(convert_ckpt, [f"ckpt_path={ckpt}", f"+out={out_dir}", "model=conditional_flow_matching"], work)
    convert_s = time.perf_counter() - t0
    meta = json.loads((out_dir / "meta.json").read_text())
    if (meta["epoch"], meta["global_step"], meta["weights_only_conversion"]) != (3, 24, True):
        raise AssertionError(f"converted meta {meta}")
    cfg = compose(REPO / "configs", "infer.yaml", ["model=conditional_flow_matching", f"ckpt_path={out_dir}",
                                                    "model.solver.solver=euler"])
    task = load_task(cfg)
    # the main path: counts zeroed just before, read just after
    zero_kernel_launches()
    got = task.generate(sealed["src"], num_steps=2)
    torch.cuda.synchronize()
    launches = kernel_launches()
    if not torch.equal(got, sealed["euler_direct"]) or launches["K1-fwd"] != 1:
        raise AssertionError(f"the converted checkpoint generates another batch (max abs "
                             f"{(got - sealed['euler_direct']).abs().max().item()}) or launched {launches}")
    del task
    program = work / "exported.pt2"
    t0 = time.perf_counter()
    _cli(export_model, [f"ckpt_path={out_dir}", "model=conditional_flow_matching", "model.solver.solver=euler",
                        "num_steps=2", f"+batch={SEALED_BATCH}", f"+image_size={SEALED_SIZE}", f"+out={program}"],
         work)
    export_s = time.perf_counter() - t0
    ours, theirs = _archive_members(program), _archive_members(sealed["euler_program"])
    differ = sorted(k for k in set(ours) | set(theirs) if ours.get(k) != theirs.get(k))
    if differ:
        raise AssertionError(f"export_model's program differs from phase 29's euler program in {differ[:5]}")
    summary = dict(card=card, convert_s=convert_s, meta=meta, infer_launches=launches, export_model_s=export_s,
                   archive_members=len(ours), same_program=True)
    log("convert-ckpt " + json.dumps(summary))
    return summary


def _sanity_report(root: Path, work: Path) -> tuple[int, dict]:
    """``python -m stain2stain_tpu_torch.data_sanity`` on ``root``, in process
    (``main(argv)``, its output captured): (its exit code, its report)."""
    import contextlib

    from stain2stain_tpu_torch import data_sanity

    argv = [f"data.data_dir={root}", "data=paired_data_mask_he_amyloid", "data.csv_file_name=metadata.csv"]
    before = os.environ.get("PROJECT_ROOT")
    os.environ["PROJECT_ROOT"] = str(work)
    buf, code = io.StringIO(), 0
    try:
        with contextlib.redirect_stdout(buf):
            try:
                data_sanity.main(argv)
            except SystemExit as exc:  # the report is printed first
                code = exc.code
    finally:
        os.environ["PROJECT_ROOT"] = before or str(REPO)
    text = buf.getvalue()
    start = text.find('{\n  "csv"')
    if start < 0:
        raise AssertionError(f"data_sanity printed no report (exit {code}):\n{text[-2000:]}")
    return code, json.JSONDecoder().raw_decode(text[start:])[0]


def phase_data_sanity(card: str, work: Path) -> dict:
    """``data-sanity``: ``stain2stain_tpu_torch.data_sanity``'s entry point on
    a synthetic masked tree (``SANITY_TILES``, 256 px): exit 0, no error,
    every probed tile 256×256; then on a copy with one source tile removed:
    exit 1, that column in ``missing_files``."""
    import shutil

    from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset

    root = work / "data-sanity"
    n_train, n_val, n_test = SANITY_TILES
    generate_paired_dataset(root, n_train=n_train, n_val=n_val, n_test=n_test, size=256, seed=0, with_mask=True)
    t0 = time.perf_counter()
    rc, report = _sanity_report(root, work)
    green_s = time.perf_counter() - t0
    if rc != 0 or report["errors"] or report["missing_files"] or report["rows"] != sum(SANITY_TILES) \
            or report["shape_histogram"] != {"256x256": 64}:
        raise AssertionError(f"data_sanity on a whole tree: exit {rc}, {report}")
    broken = work / "data-sanity-broken"
    shutil.copytree(root, broken)
    with open(broken / "metadata.csv", newline="") as fh:
        row = next(csv.DictReader(fh))
    column = [c for c in row if c.endswith("_filepath")][0]
    (broken / row["split"] / row[column]).unlink()
    rc_broken, broken_report = _sanity_report(broken, work)
    if rc_broken == 0 or broken_report["missing_files"] != {column: 1}:
        raise AssertionError(f"data_sanity with {column} removed: exit {rc_broken}, {broken_report}")
    summary = dict(card=card, rows=report["rows"], split_counts=report["split_counts"],
                   file_columns=report["file_columns"], shape_histogram=report["shape_histogram"], exit=rc,
                   seconds=green_s, broken_exit=rc_broken, broken_missing=broken_report["missing_files"])
    log("data-sanity " + json.dumps(summary))
    return summary


def check_train_s2b(summary: dict, f32_summary: dict) -> dict:
    """``train-s2b`` against phase 8 (``train-f32``) of the same call: the first
    loss within ``S2B_FIRST_LOSS_REL_TOL`` relative, the same K1 launches; the
    step and peak beside phase 8's."""
    rel = abs(summary["losses"][0] - f32_summary["losses"][0]) / abs(f32_summary["losses"][0])
    same = all(summary[k] == f32_summary[k] for k in ("k1_fwd_launches", "k1_bwd_launches"))
    result = dict(first_loss=summary["losses"][0], f32_first_loss=f32_summary["losses"][0], first_loss_rel=rel,
                  step_ms=summary["step_ms_median_3_8"], f32_step_ms=f32_summary["step_ms_median_3_8"],
                  step_ratio=summary["step_ms_median_3_8"] / f32_summary["step_ms_median_3_8"],
                  peak_gib=summary["peak_mem_gib"], f32_peak_gib=f32_summary["peak_mem_gib"],
                  k1_fwd_launches=summary["k1_fwd_launches"], k1_bwd_launches=summary["k1_bwd_launches"])
    log("train-s2b-vs-f32 " + json.dumps(result))
    if rel > S2B_FIRST_LOSS_REL_TOL or not same:
        raise AssertionError(f"train-s2b against train-f32: {result}")
    return result


def control_worker(spec: dict) -> None:
    """One seed of the quality control on the card, in a process of its own:
    its result and the kernels' launches over it to ``spec["result"]``."""
    import torch

    from stain2stain_tpu_torch.quality import control_run

    torch.set_num_threads(1)  # four workers and the tile writer share the host's cores
    zero_kernel_launches()
    run = control_run(spec["seed"], spec["work"], device="cuda")
    run["launches"] = kernel_launches()
    Path(spec["result"]).write_text(json.dumps(run))


def phase_quality_control(card: str, work: Path) -> dict:
    """33. ``quality-control``: the port's smoke-scale quality control
    (:mod:`stain2stain_tpu_torch.quality`, the counterpart of JAX's
    ``tests/test_quality_control.py``) on the card, its seeds at once, one
    process each; JAX's gates on the mean over the seeds. The tiny net's
    mid-block attention runs K1-fwd and K1-bwd in f32 at (B, 256, 32)."""
    from stain2stain_tpu_torch.quality import CONTROL_SEEDS, control_verdict

    t0 = time.perf_counter()
    procs = {}
    for seed in CONTROL_SEEDS:
        spec = dict(seed=seed, work=str(work / f"control-{seed}"), result=str(work / f"control-{seed}.json"))
        procs[seed] = (spec, subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--control-worker", json.dumps(spec)], cwd=work,
            env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    runs = []
    for seed, (spec, proc) in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            for _, other in procs.values():
                other.kill()
            raise AssertionError(f"quality control seed {seed} failed in its process:\n{out[-6000:]}")
        runs.append(json.loads(Path(spec["result"]).read_text()))
    verdict = control_verdict([dict(r, ssim={int(k): v for k, v in r["ssim"].items()}) for r in runs])
    launches = {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]}
    result = dict(card=card, seeds=[{k: r[k] for k in ("seed", "val_loss", "ssim", "psnr", "fit_s", "eval_s")}
                                    for r in runs],
                  mean_val_loss=verdict["mean_val_loss"], mean_ssim=verdict["mean_ssim"], launches=launches,
                  seconds=time.perf_counter() - t0)
    log("quality-control " + json.dumps(result))
    if verdict["failures"] or launches["K1-fwd"] == 0 or launches["K1-bwd"] == 0:
        raise AssertionError(f"the quality control failed JAX's gates on the mean over seeds "
                             f"{list(CONTROL_SEEDS)}: {verdict['failures']}, or launched no K1: {launches}")
    return result


def start_quality_tiles(work: Path) -> subprocess.Popen:
    """``scripts/torch_gen_quality_tiles.py`` writing phase 34's tree into
    ``work/quality-tiles`` in a process of its own (host work, run beside
    phase 33)."""
    return subprocess.Popen([sys.executable, str(REPO / "scripts" / "torch_gen_quality_tiles.py"),
                             str(work / "quality-tiles")], cwd=work, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def phase_quality_real(card: str, work: Path, tiles: Optional[subprocess.Popen] = None) -> dict:
    """34. ``quality-real``: the flagship quality recipe's data path and first
    epoch. ``scripts/torch_gen_quality_tiles.py`` writes the 1152-tile tree
    (``tiles``: its process, started earlier, which this phase waits for);
    ``experiment=quality_real_256`` trains on it one epoch (16 steps) through
    the entry point (``phase_train``), validates and tests; the device cache's
    decoded train tiles equal a cv2 decode of the PNGs bit for bit;
    ``eval_quality`` at 2 euler steps on its checkpoint (2 test batches of
    16) prints one JSON line."""
    import cv2
    import numpy as np
    import torch

    from stain2stain_tpu_torch import eval_quality

    t0 = time.perf_counter()
    if tiles is None:
        tiles = start_quality_tiles(work)
    out, _ = tiles.communicate(timeout=600)
    if tiles.returncode != 0:
        raise AssertionError(f"scripts/torch_gen_quality_tiles.py failed:\n{out[-3000:]}")
    root = work / "quality-tiles"
    tiles_s = time.perf_counter() - t0  # the wait for the tree in this phase
    n_png = len(list(root.rglob("*.png")))
    summary, objects = phase_train(card, work, "train-quality-real")
    dm = objects["datamodule"]
    del objects
    loader = dm.train_dataloader()
    loader._materialize()
    ds = dm.datasets["train"]
    names = ds._names(range(len(ds)))
    cache_equal = []
    for field, files in zip(loader._fields[:2], names):
        decoded = np.stack([cv2.cvtColor(cv2.imread(os.path.join(ds.tile_dir, f)), cv2.COLOR_BGR2RGB) for f in files])
        cache_equal.append(field.device.type == "cuda" and torch.equal(field.cpu(), torch.from_numpy(decoded)))
    del loader
    gc.collect()
    torch.cuda.empty_cache()

    argv = [f"ckpt_path={summary['best_path']}", "data=paired_data", f"data.data_dir={root}",
            "data.csv_file_name=metadata.csv", "data.direction=S2T", "data.image_size=256", "data.batch_size=16",
            "data.use_augmentation=false", "model=conditional_flow_matching", "model.solver.solver=euler",
            "num_steps=2", "n_batches=2"]
    zero_kernel_launches()
    t1 = time.perf_counter()
    quality, printed = _cli(eval_quality, argv, work)
    eval_launches = kernel_launches()
    lines = [ln for ln in printed.splitlines() if ln.strip()]
    result = dict(card=card, tiles=n_png, tiles_s=tiles_s, cache_equal=cache_equal, datamodule=summary["datamodule"],
                  steps=summary["steps"], step_ms=summary["step_ms_median_3_8"], peak_gib=summary["peak_mem_gib"],
                  val_loss=summary["val_loss"], test_loss=summary["test_loss"],
                  train_launches={k: summary[f"{k.lower().replace('-', '_')}_launches"]
                                  for k in ("K1-fwd", "K1-bwd", "K2", "K3", "K4", "K5")},
                  eval_quality=quality, eval_s=time.perf_counter() - t1, eval_launches=eval_launches,
                  seconds=time.perf_counter() - t0)
    log("quality-real " + json.dumps(result))
    if n_png != 2 * (512 + 32 + 32) or not all(cache_equal) or summary["datamodule"] != "PairedDataModule":
        raise AssertionError(f"quality-real: the tree, the device cache or the datamodule is wrong: {result}")
    if (len(lines) != 1 or json.loads(lines[0]) != quality or not -1.0 <= quality["ssim"] <= 1.0
            or not math.isfinite(quality["psnr"]) or quality["fid_comparable"] is not False
            or eval_launches["K1-fwd"] != 2):  # one velocity evaluation a batch, two batches
        raise AssertionError(f"quality-real: eval_quality printed {printed!r}, launches {eval_launches}")
    return result


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one tile batch, one request and train steps (where the time goes)")
    parser.add_argument("--ddp-worker", metavar="SPEC", help=argparse.SUPPRESS)  # one rank of phase 28
    parser.add_argument("--sealed-worker", metavar="SPEC", help=argparse.SUPPRESS)  # a program of phases 29-30
    parser.add_argument("--control-worker", metavar="SPEC", help=argparse.SUPPRESS)  # a seed of phase 33
    args = parser.parse_args()
    if args.control_worker:
        sys.path.insert(0, str(REPO))
        control_worker(json.loads(args.control_worker))
        return 0
    if args.ddp_worker:
        sys.path.insert(0, str(REPO))
        ddp_worker(json.loads(args.ddp_worker))
        return 0
    if args.sealed_worker:
        sys.path.insert(0, str(REPO))
        sealed_worker(json.loads(args.sealed_worker))
        return 0
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "stain2stain_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: the stain2stain_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    os.environ.setdefault("PROJECT_ROOT", str(REPO))
    started = time.perf_counter()

    # 1. device
    card = nvidia_smi("name,power.limit")
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    exp_per_s = props.multi_processor_count * MUFU_EX2_PER_CLK_PER_SM * max_clock_mhz * 1e6
    log(f"device: {card}; {props.multi_processor_count} SMs, max SM clock {max_clock_mhz} MHz; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    # 2. build
    from stain2stain_tpu_torch import _build

    t0 = time.perf_counter()
    build_logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for src, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) or "error" in line.lower():
                log(f"ptxas {src}: {line.strip()}")
    log(f"build: {build_s:.3f} s for {len(_build.SOURCES)} source(s)")
    spills = checked_spills(build_logs)
    log("ptxas-spills " + json.dumps(spills))
    missing = [src for src in SPILL_CHECKED if not any(k.startswith(src + ":") for k in spills)]
    if sum("tf32_kernel" in k for k in spills) != 6:  # K1-bwd's f32 passes 2 and 3 at D 16, 32, 64
        missing.append("the six 3xTF32 kernels of attention_bwd.cu")
    if missing or any(spills.values()):
        raise AssertionError(f"ptxas spilled in a checked kernel, or reported none for {missing}: {spills}")

    seconds: dict = {}

    def timed(label, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        seconds[label] = time.perf_counter() - t
        log(f"phase {label}: {seconds[label]:.1f} s")
        return result

    # 3-4. K1-fwd and K1-bwd against their plain versions
    k1 = timed("k1-fwd", phase_kernels, exp_per_s)
    k1_bwd = timed("k1-bwd", phase_k1_bwd, exp_per_s)
    # 36. the hash dropout kernel against the plain product
    dropout = timed("dropout-kernel", phase_dropout_kernel, card)
    # 38. the LayerNorm-modulate kernels against the plain chain
    ln = timed("ln-modulate-kernel", phase_ln_modulate_kernel, card)

    # 5. the serving path at full width
    summary, net = timed("serve", phase_slice, card)

    # 6. kernel path vs plain path, end to end
    parity = timed("unet-parity", phase_unet_parity, net)
    if args.profile:
        phase_profile(net, card)

    # 29-31 (run here, on phase 5's net): the sealed generator, the converted checkpoint, the data sanity check
    (REPO / "scratch").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_", dir=REPO / "scratch") as work:
        work = Path(work)
        sealed = timed("serve-sealed", phase_serve_sealed, card, net, work)
        converted = timed("convert-ckpt", phase_convert_ckpt, card, net, work, sealed)
        sanity = timed("data-sanity", phase_data_sanity, card, work)
        sealed = sealed["results"]
    del net
    gc.collect()
    torch.cuda.empty_cache()

    # 7-18 write their synthetic data and checkpoints in a gitignored scratch dir
    (REPO / "scratch").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_", dir=REPO / "scratch") as work:
        work = Path(work)
        # 7. the training path at full width
        train_summary, _ = timed("train", phase_train, card, work)
        torch.cuda.empty_cache()

        # 8. f32 training at 512 px, batch 6: the f32 K1-fwd and K1-bwd
        f32_summary, _ = timed("train-f32", phase_train, card, work, "train-f32")
        torch.cuda.empty_cache()

        # 37. the DiT in bf16 on phase 8's data: K1 at head dim 72
        dit_summary, _ = timed("train-dit", phase_train, card, work, "train-dit")
        gc.collect()
        torch.cuda.empty_cache()
        if args.profile:
            phase_profile_train(card, "profile-train-f32")
            torch.cuda.empty_cache()

        # 9. f32 gradients, card vs CPU
        grad = timed("grad-parity", phase_grad_parity)
        if args.profile:
            torch.cuda.empty_cache()
            phase_profile_train(card)

        # 10. K2-K5 against their plain versions
        torch.cuda.empty_cache()
        convs = timed("k2-k5", phase_conv_kernels, exp_per_s)
        timed("conv-sweep", phase_conv_sweep, exp_per_s)

        # 11. the training path with fused_conv=true, on the same synthetic data
        torch.cuda.empty_cache()
        fused_summary, _ = timed("train-fused", phase_train, card, work, "train-fused")
        torch.cuda.empty_cache()

        # 12. the fused path's bf16 gradients, card vs CPU
        fused_grad = timed("fused-grad-parity", phase_fused_grad_parity)
        if args.profile:
            torch.cuda.empty_cache()
            phase_profile_train(card, "profile-train-fused")
        torch.cuda.empty_cache()

        # 13. train-remat: phase 8's operating point with use_checkpoint=level through
        # the entry point, every mode's memory and step, remat against no remat, and
        # the fused path with level remat
        remat_summary, _ = timed("train-remat", phase_train, card, work, "train-remat")
        gc.collect()
        torch.cuda.empty_cache()
        timed("remat-modes", phase_remat_modes, card)
        timed("remat-parity", phase_remat_parity)
        fused_remat_summary, _ = timed("train-fused-remat", phase_train, card, work, "train-fused-remat")
        torch.cuda.empty_cache()

        # 14. any2any: the experiment through the entry point, then served per class
        from stain2stain_tpu_torch.data.synthetic import generate_domain_folders

        timed("any2any-data", generate_domain_folders, work / "domains", ("HE", "IHC", "Grayscale"),
              ANY2ANY_TILES, 256, 0)
        log("train-any2any: data.batch_size=32, cut from the experiment's global batch of 128 "
            "(the reference split it over several GPUs)")
        any2any_summary, any2any_objects = timed("train-any2any", phase_train, card, work, "train-any2any")
        serve_any2any = timed("serve-any2any", phase_serve_any2any, card, any2any_objects["model"])
        del any2any_objects
        gc.collect()
        torch.cuda.empty_cache()

        # 15. evaluation and the inference CLIs
        timed("eval", phase_eval, card, work, train_summary, any2any_summary)
        gc.collect()
        torch.cuda.empty_cache()

        # 16-18. the mask studies
        masks = mask_phases(card, work, timed)

        # 19-21. the multitask studies (no K1-K5 on their paths)
        multitask = multitask_phases(card, work, timed)
        if args.profile:
            for name in ("profile-train-multitask", "profile-train-multitask-group"):
                gc.collect()
                torch.cuda.empty_cache()
                phase_profile_train(card, name)

        # 22-23. phase 7's path under the W&B logger, then resumed from its logged model under the profiler
        gc.collect()
        torch.cuda.empty_cache()
        wandb_summary = timed("train-wandb", phase_train_wandb, card, work)
        gc.collect()
        torch.cuda.empty_cache()
        resume_summary = timed("train-resume", phase_train_resume, card, work, wandb_summary)
        gc.collect()
        torch.cuda.empty_cache()

        # 25. the template's MNIST sweep through the entry point (24 ran with the mask phases)
        sweep = timed("mnist-sweep", phase_mnist_sweep, card, work)
        gc.collect()
        torch.cuda.empty_cache()

        # 32. phase 8's point with s2b_conv=2 (under the expandable segments set before phase 16)
        s2b_summary = timed("train-s2b", phase_train, card, work, "train-s2b")[0]
        s2b = check_train_s2b(s2b_summary, f32_summary)
        gc.collect()
        torch.cuda.empty_cache()

        # 33-34. the quality recipe: the smoke-scale control (quality_real_256's tree written beside
        # it), then that tree's first epoch
        tiles = start_quality_tiles(work)
        control = timed("quality-control", phase_quality_control, card, work)
        quality_real = timed("quality-real", phase_quality_real, card, work, tiles)
        gc.collect()
        torch.cuda.empty_cache()

    # 26. FastDropout(impl="bits") on the card
    gc.collect()
    torch.cuda.empty_cache()
    bits = timed("dropout-bits", phase_dropout_bits, card)
    torch.cuda.empty_cache()

    # 27-28. data-parallel training: NCCL in a world of 1 through the CLI, then two gloo ranks on the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_", dir=REPO / "scratch") as work:
        work = Path(work)
        ddp_summary = timed("train-ddp", phase_train_ddp, card, work, f32_summary)
        ddp2_summary = timed("train-ddp-2rank", phase_train_ddp_2rank, card, work, ddp_summary)
    gc.collect()
    torch.cuda.empty_cache()
    cond_summary, infer_cond, mask_paths = masks["train-masked-conditioned"], masks["infer-conditional"], masks["short"]
    serve_bound = masks["serve-mask-bound"]
    (mt_summary, mt_infer), (mc_summary, mc_infer) = (multitask[n] for n in MULTITASK_PATHS)
    log("phase-seconds " + json.dumps(seconds))

    # the multitask paths' launches of each kernel (none: their nets have no
    # attention and their convs are cuDNN's)
    mt_launches = {
        kernel: {"train_multitask": mt_summary[key], "infer_multitask": mt_infer["infer"]["launches"][kernel],
                 "serve_multitask": mt_infer["serve"]["launches"][kernel],
                 "train_multitask_multiclass": mc_summary[key],
                 "infer_multitask_multiclass": mc_infer["infer"]["launches"][kernel],
                 "multitask_grad_parity": sum(r["launches"][kernel] for r in multitask["multitask-grad-parity"].values())}
        for kernel, key in (("K1-fwd", "k1_fwd_launches"), ("K1-bwd", "k1_bwd_launches"), ("K2", "k2_launches"),
                            ("K3", "k3_launches"), ("K4", "k4_launches"), ("K5", "k5_launches"))
    }

    # this slice's paths' launches of each kernel: K1-fwd and K1-bwd on the W&B and resumed runs, K1-fwd on the
    # bound-mask server, none on the MNIST study
    slice_launches = {
        kernel: {"train_wandb": wandb_summary[key], "train_resume": resume_summary[key],
                 "serve_mask_bound": (serve_bound["k1_launches"] if kernel == "K1-fwd"
                                      else serve_bound["other_launches"][kernel]),
                 "mnist_sweep": sweep["launches"][kernel]}
        for kernel, key in (("K1-fwd", "k1_fwd_launches"), ("K1-bwd", "k1_bwd_launches"), ("K2", "k2_launches"),
                            ("K3", "k3_launches"), ("K4", "k4_launches"), ("K5", "k5_launches"))
    }
    log("slice-11 " + json.dumps({"dropout_bits": {k: bits[k] for k in ("bits_ms", "hash_ms", "keep_fraction")},
                                  "mnist_sweep_s": sweep["seconds"], "mnist_best": sweep["best"]}))
    # phases 29-32: the loaded sealed programs (and export_model's), the converted checkpoint's generate, train-s2b
    tools_launches = {
        kernel: {"serve_sealed": sum(r["loaded_launches"][kernel] for r in sealed.values()),
                 "infer_converted": converted["infer_launches"][kernel], "train_s2b": s2b_summary[key]}
        for kernel, key in (("K1-fwd", "k1_fwd_launches"), ("K1-bwd", "k1_bwd_launches"), ("K2", "k2_launches"),
                            ("K3", "k3_launches"), ("K4", "k4_launches"), ("K5", "k5_launches"))
    }
    # phases 33-34: the quality control's four seeds, quality_real_256's epoch and its eval_quality
    quality_launches = {
        kernel: {"quality_control": control["launches"][kernel],
                 "train_quality_real": quality_real["train_launches"][kernel],
                 "eval_quality_real": quality_real["eval_launches"][kernel]}
        for kernel in ("K1-fwd", "K1-bwd", "K2", "K3", "K4", "K5")
    }
    log("slice-15 " + json.dumps({
        "quality_control": {k: control[k] for k in ("seeds", "mean_val_loss", "mean_ssim", "seconds")},
        "quality_real": {k: quality_real[k] for k in ("tiles_s", "cache_equal", "step_ms", "peak_gib", "val_loss",
                                                      "test_loss", "eval_quality", "seconds")}}))
    log("slice-13 " + json.dumps({
        "serve_sealed": {name: {k: r[k] for k in ("export_s", "program_mb", "load_s", "first_call_s", "loaded_ms",
                                                  "direct_ms", "max_abs_err", "velocity_evals")}
                         for name, r in sealed.items()},
        "convert_ckpt_s": converted["convert_s"], "export_model_s": converted["export_model_s"],
        "data_sanity_s": sanity["seconds"], "train_s2b": s2b}))

    # 35. result lines
    def row(name, source, replaces, case, launches, by_path, passed):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": case["max_abs_err"],
            "ms": case["ms"],
            "queued_ms": case["queued_ms"],
            "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "shape": case["shape"],
            "dtype": case["dtype"],
            "passed": passed,
        }

    # each kernel's first case is the shape and dtype its main path runs most
    # (for K2-K5 the first-level shape, whose pixels dominate the step)
    conv_ok = all(m["ok"] for m in convs["masks"]) and fused_grad["ok"]
    conv_sources = {  # kernel: (row name, source, TPU kernel, launch key of the fused train phase)
        "K2": ("fused_conv3x3 (K2)", "conv3x3_fwd.cu", "stain2stain_tpu/ops/pallas_conv.py:164", "k2_launches"),
        "K3": ("conv3x3_input_grad (K3)", "conv3x3_fwd.cu", "stain2stain_tpu/ops/pallas_conv.py:307",
               "k3_launches"),
        "K4": ("prologue_grad (K4)", "prologue_grad.cu", "stain2stain_tpu/ops/pallas_conv.py:319", "k4_launches"),
        "K5": ("conv3x3_weight_grad (K5)", "conv3x3_wgrad.cu", "stain2stain_tpu/ops/pallas_conv.py:417",
               "k5_launches"),
    }
    kernels = [
        row("attention_fwd (K1-fwd)", "stain2stain_tpu_torch/csrc/attention_fwd.cu",
            "stain2stain_tpu/ops/pallas_attention.py:64", k1["cases"][0], summary["k1_launches"],
            {"serve": summary["k1_launches"], "train": train_summary["k1_fwd_launches"],
             "train_f32": f32_summary["k1_fwd_launches"], "train_dit": dit_summary["k1_fwd_launches"],
             "train_fused": fused_summary["k1_fwd_launches"],
             "train_remat": remat_summary["k1_fwd_launches"], "train_fused_remat": fused_remat_summary["k1_fwd_launches"],
             "train_any2any": any2any_summary["k1_fwd_launches"], "serve_any2any": serve_any2any["k1_launches"],
             "train_masked_conditioned": cond_summary["k1_fwd_launches"], "serve_toggle": infer_cond["serve"]["k1_launches"],
             **{n.replace("-", "_"): m["k1_fwd_launches"] for n, m in mask_paths.items()}, **mt_launches["K1-fwd"],
             **slice_launches["K1-fwd"], "train_ddp": ddp_summary["k1_fwd_launches"],
             "train_ddp_2rank": sum(ddp2_summary["k1_fwd_launches"]), **tools_launches["K1-fwd"],
             **quality_launches["K1-fwd"]},
            all(c["ok"] for c in k1["cases"]) and parity["ok"]),
        row("attention_bwd (K1-bwd)", "stain2stain_tpu_torch/csrc/attention_bwd.cu",
            "stain2stain_tpu/ops/pallas_attention.py:78", k1_bwd["cases"][0], train_summary["k1_bwd_launches"],
            {"train": train_summary["k1_bwd_launches"], "train_f32": f32_summary["k1_bwd_launches"],
             "train_dit": dit_summary["k1_bwd_launches"], "train_fused": fused_summary["k1_bwd_launches"], "train_remat": remat_summary["k1_bwd_launches"],
             "train_fused_remat": fused_remat_summary["k1_bwd_launches"],
             "train_any2any": any2any_summary["k1_bwd_launches"],
             "train_masked_conditioned": cond_summary["k1_bwd_launches"],
             **{n.replace("-", "_"): m["k1_bwd_launches"] for n, m in mask_paths.items()}, **mt_launches["K1-bwd"],
             **slice_launches["K1-bwd"], "train_ddp": ddp_summary["k1_bwd_launches"],
             "train_ddp_2rank": sum(ddp2_summary["k1_bwd_launches"]), **tools_launches["K1-bwd"],
             **quality_launches["K1-bwd"]},
            all(c["ok"] for c in k1_bwd["cases"]) and grad["ok"] and masks["mask-grad-parity"]["ok"]),
    ] + [
        row(title, f"stain2stain_tpu_torch/csrc/{source}", replaces, convs["rows"][k][0], fused_summary[key],
            {"train_fused": fused_summary[key], "train_fused_remat": fused_remat_summary[key], **mt_launches[k],
             **slice_launches[k], **tools_launches[k], **quality_launches[k]},
            all(c["ok"] for c in convs["rows"][k]) and conv_ok)
        for k, (title, source, replaces, key) in conv_sources.items()
    ] + [
        row("hash_dropout", "stain2stain_tpu_torch/csrc/dropout.cu",
            "none: stain2stain_tpu/ops/dropout.py::hash_dropout is plain jnp, fused by XLA",
            dict(dropout["timings"][0], max_abs_err=dropout["max_abs_err"], library_ms=None), train_summary["dropout_launches"],
            {"train": train_summary["dropout_launches"], "train_f32": f32_summary["dropout_launches"],
             "train_dit": dit_summary["dropout_launches"],
             "train_fused": fused_summary["dropout_launches"], "train_remat": remat_summary["dropout_launches"],
             "train_fused_remat": fused_remat_summary["dropout_launches"],
             "train_any2any": any2any_summary["dropout_launches"],
             "train_masked_conditioned": cond_summary["dropout_launches"],
             **{n.replace("-", "_"): m["dropout_launches"] for n, m in mask_paths.items()},
             "train_s2b": s2b_summary["dropout_launches"]},
            not dropout["bad"]),
    ] + [
        row(f"ln_modulate_{part}", "stain2stain_tpu_torch/csrc/layer_norm_modulate.cu",
            "none: the JAX package has no DiT; the plain chain is ops/norms.py::_LayerNormModulate",
            dict(ln[part], max_abs_err=ln["max_abs_err"], plain_ms=ln[part]["plain_queued_ms"],
                 library_ms=ln[part].get("library_queued_ms"), bound_by="bytes", shape=ln["shape"], dtype=ln["dtype"]),
            dit_summary[f"ln_modulate_{part}_launches"],
            {path: s[f"ln_modulate_{part}_launches"] for path, s in (
                ("train", train_summary), ("train_f32", f32_summary), ("train_dit", dit_summary),
                ("train_fused", fused_summary), ("train_remat", remat_summary),
                ("train_any2any", any2any_summary), ("train_masked_conditioned", cond_summary))},
            not [c for c in ln["cases"] if not c["ok"]])
        for part in ("fwd", "bwd")
    ]
    log(f"total: {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
