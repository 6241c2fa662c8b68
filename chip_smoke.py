#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one JSON line:
  1. device: the card (nvidia-smi name and power limit), torch/CUDA/nvcc
     versions; TF32 off for convolutions and matmuls throughout;
  2. build: every hand-written kernel built from ``adaptiveisp_tpu_torch/ops/
     cuda/csrc`` (one nvcc per source, all started together);
  3. kernel: each kernel against its plain PyTorch version on the card, at
     the main path's shape and at an odd shape, with its time, the plain
     version's time and the card's bound for the same work: K1 and K2, also
     on flat 8 x 8 patches (exact zero distances, images at h = 0 and
     1e-4) and on a [1,6,9,3] image smaller than the halo, K1 with
     ``sym=True`` (JAX's K3, served by K1) bit for bit equal to
     ``sym=False`` in the same four cases and timed in turns with it; K4
     (the fused render pass) on the bench's 5-stage chain at [8,512,512,3]
     with per-image parameters, a pointwise stack on exact 0/1,
     out-of-range, grey and two-channel-tie pixels, four sharpens
     interleaved with pointwise stages at [2,37,53,3], [1,6,9,3] and
     [1,2160,3840,3], and the pointwise stack at [1,2160,3840,3]; each
     timed case twice: the kernel alone (its C entry on prepared arguments,
     launched while the card still writes a 128 MB buffer, so that the
     events bracket the kernel and it reads past a flushed L2) and the
     call (``render_pipeline_fused``); one profiled call, whose only device
     work must be K4; then the registered operator ``nlm_gray`` with
     ``sym=True`` forward and backward once
     (K1, then K2; the launch counts of this run are the ``kernel_sym``
     path);
  4. serving: the port's serving path at full width, through the user entry
     points: ``api.load_adaptive_isp().process`` (Config() defaults, 5-step
     blend rollout) then ``api.load_detector().detect`` (full YOLOv3, decode,
     NMS), batch 8 @ 512 px, seeded random weights; launch counts read around
     that run; step 0 held against the port's own CPU run;
  5. train: the actor-critic train step (``train.step.make_train_step``) at
     full width, Config() and TrainConfig(batch_size=8) defaults, the full
     YOLOv3 as the frozen reward detector in bf16 (the trainer's default)
     and in f32, batch 8 @ 512 px, two detector forwards per step; launch
     counts read around the 10 timed steps of each (K1 in the forward, K2 in
     the backward, once per step); one f32 step at batch 2 @ 128 px held
     against the port's own CPU run;
  6. render: the scripted render through its entry point,
     ``render_isp.main`` at ``--batch 8`` on 8 seeded 512 x 512 PNGs (under
     ``build/render_smoke``) with a chain split by denoise; launch counts
     read around that run (exactly 2 K4 and 1 K1); every saved PNG against
     the port's CPU chain; then ``render_pipeline`` timed for the bench's
     5-stage chain at batch 8 @ 512 and 2 x 2160 x 3840 and the split chain
     at batch 8 @ 512, MPix/s beside the eager chain's;
  7. fused_grad: one ``fused_run`` gradient at batch 2 @ 128 px (image and
     every stage's parameters) against autograd of the plain chain;
  8. trainer: the RL trainer loop through ``train.trainer.Trainer`` at full
     width: Config() roster (denoise included), a 128-slot device pool of
     512 x 512 images with cached rewards, batch 8, the full YOLOv3 reward
     detector in bf16, seeded random weights, on 64 seeded PNGs with 2-5
     boxes each under ``build/train_smoke`` (a data YAML, source
     ``normalize``, 8 validation images); 3 warm-up then 20 timed
     iterations (checkpoints and validation trajectories every 10), each
     split by CUDA events into sample, the step's phases and write-back,
     launch counts read around the 20 (one K1 and one K2 an iteration, ten
     K1 a validation); the automatic checkpoint at step 20 on disk; the
     final state saved and resumed into a second Trainer, equal to it bit
     for bit; then ``train_isp.main`` for 2 iterations with the device pool
     and with the host pool;
  9. trainer_vs_cpu: the same seeded Trainer (YOLOv3-tiny in f32, batch 2 @
     128 px, dropout off, a 16-slot pool) on the card and on the CPU: 3
     iterations, then a stopped trajectory and a diverged batch written
     back into the pool (both refresh their slots), then a 4th iteration;
     sampled slots, states, slot metadata and refresh counts equal,
     history, pool images and cached losses to 1e-3;
 10. validation: ``eval.validator.run_validation`` on the trainer data's 8
     validation PNGs at the reference protocol (512 px, 5 steps, conf
     0.001, IoU 0.6, max_det 300), Config() agent and full YOLOv3 with
     ``spread_detector_state`` weights: batch 1 (switch render) free and
     with denoise forced first (4 images), batch 8 (blend), and batch 1
     with merge-NMS and TTA (2 images); each with its speed report, wall ms
     per image and launch counts, and each against the same call on the
     CPU (records
     equal, mAP50 and mAP within 0.01); then the free runs at batch 1
     and 8 with ``profile=True`` (each bucket of the speed report waits
     for the card), the free batch-1 run with the host's reads of device
     values (rollout, NMS) timed, and under the profiler (device kernel
     time against wall time);
 11. val_cli: ``val_isp.main`` on the same data with the validation
     phase's agent and detector from files, every artifact on but the
     plots (no matplotlib there); records equal the validation phase's;
 12. hr_render: ``eval.hr_render.run_hr_validation`` on two seeded PNGs of
     683 x 512 and 512 x 341 (full-resolution frames 384 x 512 and the odd
     341 x 512) on the card and the CPU, frames before PNG quantisation
     within 1e-4; then ``train_isp.main(["--task", "val", ...])``;
 13. fixed_pipeline: ``optimize_fixed_pipeline`` over exposure -> denoise
     -> gamma -> sharpen, full YOLOv3, 12 steps at batch 8 @ 512 (K1 and K2
     each step) with the step timed alone; the same optimisation at 512
     px cut to 3 steps at batch 2 on the card and the CPU (history, raw
     and squashed parameters within 1e-3); one ``make_fixed_pipeline_step``
     on the 5-stage chain with the fused render (K4 forward, its gradient
     through the plain chain) against ``allow_fused=False``;
 14. detector_train: detector training at full width through
     ``detect.train_loop.DetectorTrainer``: full YOLOv3 (61.9 M parameters,
     80 classes), 640 px, batch 16, f32, the default hyp (mosaic, HSV,
     flips, perspective) on 32 seeded synthetic-shapes PNGs under
     ``build/det_smoke`` (16 more for validation), 2 epochs of 2 steps with
     validation and checkpoints each epoch; step ms (CUDA events, the
     optimizer update and the EMA apart), images/s, the host's data ms per
     batch against the step's device ms and the busy share, validation and
     checkpoint seconds, peak memory; losses finite, the EMA moved, and a
     trainer resumed from the first epoch's checkpoint repeats the second
     epoch bit for bit (cuDNN deterministic in this phase);
 15. detector_vs_cpu: the same full YOLOv3 at batch 2 @ 256 px,
     augmentation off, 2 train steps on the card and on the CPU from one
     state: loss, parameters, BatchNorm statistics and EMA within the
     tolerances its docstring states and justifies, with how far the
     parameters moved;
 16. detector_cli: ``detect.train_loop.main --spec yolov3 --imgsz 640
     --batch-size -1 --epochs 1`` on the same images (autobatch's choice
     printed), and its best.pt as ``val_isp --weights`` on 4 images;
 17. hub: ``api.yolov3()``, ``api.yolov3_spp()`` and ``api.yolov5s()`` on
     the card at 640 px with ``spread_detector_state`` weights (seeded;
     a fresh detector's scores all sit near 0.25), each forward's decoded
     predictions against the same state_dict on the CPU;
     ``Detector.__call__`` on a path, a PIL image and a uint8 array
     against the CPU's; an NMS ensemble of two YOLOv3 weight files
     (written under ``build/hub_smoke``) against the CPU's;
 18. rest: ``serve.rest`` on port 0 on the card (the hub's YOLOv3 file, the
     Config() agent with denoise's selector bias raised so that it picks
     denoise at every step, from a weights file, at 512 px): 8 POSTs of
     PNGs of different sizes (launch counts read around them), /healthz,
     a bad body (400); every answer equal to the in-process
     ``rest.infer``; latency median and p90; one profiled request;
 19. detect_cli: ``detect_cli.main --device cuda --isp_weights ...
     --save_txt --save_img`` on 8 PNGs under ``build/cli_smoke`` (launch
     counts read around it), its label files against a ``--device cpu``
     run on the first 2;
 20. raw_unprocess: ``raw.unprocess.unprocess_batch`` at [8,512,512,3] on
     the card, replayed with its metadata on the card and on the CPU;
 21. segment_train: ``detect.segment.SegmentTrainer`` at full width:
     YOLOv3's widths with the Segment head (80 classes, nm 32, npr 256),
     640 px, batch 16, masks at 160 x 160, flips and copy-paste, one epoch
     over 48 seeded synthetic polygon PNGs (2-5 instances each) under
     ``build/seg_smoke`` with box + mask validation on 16 more; step ms
     (CUDA events), the host's data ms a batch, busy share, peak memory,
     box and mask mAP;
 22. segment_vs_cpu: the same spec at batch 2 @ 128 px, three train steps
     on the card and on the CPU from one state (loss, parameters, EMA);
 23. segment_cli: the predict CLI (``--spec yolov3 --imgsz 640
     --save_txt``, ``spread_detector_state`` weights) on 8 PNGs, ms per
     frame, card against ``--device cpu`` on 2 (boxes as multisets, mask
     IoU of matched instances); then ``train`` for one epoch and
     ``--validate-only`` on its checkpoint;
 24. classify_train: ``classify.ClassifierTrainer`` with the Darknet-53
     backbone (``ClassificationModel(spec=YOLOV3_SPEC)``), 10 classes,
     224 px, batch 64, one epoch over 640 seeded images under
     ``build/cls_smoke`` (top-1 / top-5 on 160): step ms, images/s, the
     host's data ms, busy share; then the classify CLI with its default
     backbone and ``--validate-only``;
 25. classify_vs_cpu: three steps per optimizer (SGD, Adam, AdamW,
     RMSProp) at batch 4 @ 64 px on the card and on the CPU, then
     ``predict`` and ``apply_classifier`` over the hub phase's YOLOv3
     detections; the segmentation and classification phases launch none
     of K1-K4 (their counts are printed);
 26. export: the Config() agent biased to denoise through
     ``detect.export.export_adaptive_isp`` on the card (batch 1 @ 512, 5
     steps), saved, reloaded and run (launch counts read around that run:
     K1 once a step) against the eager rollout on the card, then moved to
     the CPU against the port's CPU rollout; full YOLOv3 through
     ``export_detector`` the same way; ``python -m
     adaptiveisp_tpu_torch.export_cli --include pt2 variables --validate``
     as a subprocess;
 27. triton: ``serve.triton.TritonRemoteModel`` against an in-script
     KServe-v2 server backed by YOLOv3 on the card (640 px, batch 1),
     outputs bit for bit the direct forward's, latency median and p90;
 28. trace_breakdown: three bf16 train steps at batch 8 @ 512 under
     ``obs.profile.trace``, device time by the step's components
     (``obs.trace.component_breakdown``), MFU against
     ``obs.roofline.device_peaks``; fails when more than 15 % of the
     device time falls outside every component;
 29. dp (``phase_dp``): data parallelism, two ranks on the one card
     (gloo over CUDA tensors: NCCL refuses two ranks on one device), each
     rank a fresh process (``parallel.launch``) running ``dp_rank``,
     every number beside the single process's run on the card:
     dp_train_step, 3 steps of the denoise-biased Config() agent (dropout
     on) with YOLOv3 f32 and bf16 at global batch 8 @ 512 (4 a rank),
     losses and reward within JAX's sharded-step tolerances, parameters
     within the optimizer-noise bound (``_update_errs``), the ranks'
     replicas bit for bit, K1 and K2 3 each a rank; dp_trainer,
     ``Trainer(mesh=)`` at the RL path's full width (Config(), bf16
     YOLOv3, global batch 8 @ 512) with the 128-slot pool (64 a rank), 3
     iterations, a forced refresh on each shard and one more iteration:
     finite history and pool, the ranks' history, sampled slots, states
     and metadata bit for bit equal, K1 and K2 at least 3 each a rank;
     dp_trainer_vs_cpu, the same at batch 4 @ 128 (YOLOv3-tiny f32,
     dropout off) held against the same two ranks on the CPU
     (``dp_trainer_rank``) as trainer_vs_cpu holds the single trainer;
     dp_cli, ``train_isp --dp 1`` (NCCL, one rank) against ``--dp 0``,
     the live checkpoint payload and history, each run's ms an iteration;
     dp_validation, ``run_validation(mesh=)`` at batch 8, records and
     mAP50 equal to one process's; dp_detector, dp_segment, dp_classify,
     one step of YOLOv3 at 640 (batch 16), YOLOv3-seg at 640 (16) and
     Darknet-53 at 224 (64), the loss within 2e-4 and every tensor within
     JAX's sharded detector tolerances (2e-3, 2e-5); every rank's exit
     code checked;
 30. axes (``phase_axes``): JAX's other parallel axes, two gloo ranks on
     the one card as (1 x 2) meshes, one launch (``axes_rank``), each
     against the single process on the card: sp_render,
     ``make_sharded_render`` on 2 x 2160 x 3840 frames through exposure,
     improved_wb, ccm, gamma, denoise and sharpen, each rank's 1080 rows
     within 1e-6 (the pointwise stages and sharpen exactly; the largest
     difference printed by stage), K1 once a rank; sp_hr, ``train_isp
     --task val --spatial_shard 2`` on the hr_render phase's frames (384
     and the odd 341 rows) against ``--spatial_shard 1``, every frame
     within 1e-6; ep_blend, ``make_ep_blend_render`` (5 filters a rank)
     at 8 @ 512 with one-hot weights (two images on denoise: K1 once on
     the rank that owns it, never on the other) and soft weights against
     ``render_blend``, within 1e-5 relative and 1e-6; pp_cli,
     ``render_isp --pipe 2 --window 4 --batch 2`` (denoise, sharpen_usm)
     on the render phase's 8 PNGs against ``--pipe 0``, PNGs equal, K1 on
     the denoise rank only, and whether gloo sends CUDA tensors;
     tp_detector, ``shard_detector_train_step`` (``DetectorTrainer(mesh=
     make_mesh_dp_tp(1, 2))``) on YOLOv3 at 640, batch 16, f32, two steps:
     losses within 1e-5 relative, the gathered model and EMA within 2e-3 /
     2e-5, each rank holding half of the split tensors' parameters and
     moments; then ``train_loop --tp 1 --dp 1`` on NCCL against no mesh,
     one epoch of the detector images, last.pt bit for bit;
and in the serving phase the port's mAP: ``summarize`` of the card's and
the CPU's detections of 2 served images (YOLOv3 with seeded weights that
do not saturate its head, ``spread_detector_state``) against the same
labels (the CPU chain's top detections, jittered), within 0.01 of each
other.  Then each phase's seconds, the kernels line (each kernel's
launches by path, each path's counts set to 0 just before its run and
read just after: serving, train_bf16, train_f32, render, trainer,
train_isp, train_isp_host_pool, validation_b1_free, validation_b1_forced,
validation_b8_blend, validation_b1_merge_tta, val_cli, hr_render,
train_isp_val, fixed_pipeline, fixed_step_fused, rest, detect_cli,
export, dp_train_step_f32/rank<r>, dp_train_step_bf16/rank<r>,
dp_trainer/rank<r>, dp_validation/rank<r>, dp_cli, sp_render/rank<r>,
sp_hr/rank<r>, ep_blend/rank<r>, pp_cli/rank<r>, kernel_sym; the CPU
comparisons' card runs count on none), the card's name and power limit,
and as the last line ``{"ok": true, "device":
{...}}``.  Exits non-zero, with no result line, without a CUDA device or
when any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

STARTED = time.perf_counter()

# NVIDIA H100 SXM data-sheet peaks at the full 700 W: HBM bytes/s and FP32
# (non-tensor-core) operations/s.  SFU rate: 132 SMs x 16 special-function
# results per clock x 1.98 GHz boost (Hopper architecture white paper).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9

SERVE_BATCH, SERVE_SIZE, STEPS = 8, 512, 5
UHD = (2160, 3840)   # the render phase's large frame
FORCED = [4, -1, -1, -1, -1]   # step 0 = denoise for every image
REPS = 5
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
TRAINER_WARMUP, TRAINER_ITERS = 3, 20
TRAINER_IMAGES, TRAINER_VAL = 64, 8
MAIN_GATE = np.array([1, 0, 0.3, 1, 0, 1, 1, 0], np.float32)
# 32 training images (2 steps an epoch at 16) since PR 13: the detector
# phases' depth, cut to keep the smoke with the axes phases in its time
DET_IMAGES, DET_VAL, DET_SIZE, DET_BATCH = 32, 16, 640, 16
DET_EPOCHS = 2
DET_CPU_SIZE, DET_CPU_BATCH, DET_CPU_STEPS = 256, 2, 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def only(**counts):
    """The launch counts of a run that launched these kernels this often
    and no other kernel."""
    from adaptiveisp_tpu_torch.ops.cuda import build

    return {k: counts.get(k, 0) for k in build.LAUNCHES}


def cuda_time_ms(fn, reps: int):
    """Median device time of fn() over reps launches (CUDA events)."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    from adaptiveisp_tpu_torch.ops.cuda.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc[-1] if nvcc else None,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi


def phase_build():
    from adaptiveisp_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, v in logs.items()}
    emit({"phase": "build", "seconds": secs, "built": sorted(logs),
          "ptxas": ptxas})


def bound(nbytes: int, ops: int, sfu_ops: int):
    """Least time for this work: bytes over the HBM rate against FP32
    operations over the FP32 rate (the table's rates; the special-function
    units' time beside it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "sfu_ms": sfu_ops / SFU_OPS_PER_S * 1e3}


def nlm_bound(n_on: int, n: int, h: int, w: int):
    """The gated NLM forward (K1, which also serves K3) for these
    inputs: each input read once, each output written once.  The weight of
    offset -d at p is that of d at p - d, so per gated-on pixel the least
    arithmetic is 60 weights of 13 operations (difference, square,
    separable 5x5 box sum, sqrt, divide, exp; 3 of them on the
    special-function units) and 121 terms of 7 (weight sum and three
    multiply-adds)."""
    px_on, px = n_on * h * w, n * h * w
    return bound(px_on * 12 + px * 16 + n * 8, px_on * (60 * 13 + 121 * 7),
                 px_on * 60 * 3)


def nlm_bwd_bound(n_on: int, n: int, h: int, w: int):
    """The gated NLM backward for these inputs: rgb, v and U (12 bytes a
    pixel each) and W (4) read once for the gated-on images, dL/drgb (12)
    written for every image.  The weight of -d at p is that of d at p - d,
    and the adjoints of d and -d share that chain and one box sum, so per
    gated-on pixel the least arithmetic is, for each of the 60 pairs, the
    forward's weight of 13 operations (3 on the special-function units) and
    43 for both offsets' adjoints: 12 (g_d and g_-d: three multiply-adds
    each) + 2 (their sum, times w) + 2 (strength term and its sum) + 3 (db:
    two multiplies, a divide) + 8 (box sum of db) + 2 (Z = 2 diff box(db))
    + 2 (Z(p) - Z(p + d) into dL/dy) + 12 (six direct multiply-adds), 1 (the
    divide) on the special-function units."""
    px_on, px = n_on * h * w, n * h * w
    return bound(px_on * (12 * 3 + 4) + px * 12 + n * 12,
                 px_on * 60 * (13 + 43), px_on * 60 * (3 + 1))


def _nlm_inputs(rng, n, hgt, wid, dev):
    """rgb a little outside [0, 1] with exact 0 and 1 pixels (the clip
    ties), h with a gated-on image at zero strength."""
    import torch

    rgb = rng.uniform(-0.05, 1.05, (n, hgt, wid, 3)).astype(np.float32)
    flat = rgb.reshape(-1)
    ties = rng.choice(flat.size, flat.size // 10, replace=False)
    flat[ties[::2]], flat[ties[1::2]] = 0.0, 1.0
    h = rng.uniform(0.02, 1.0, (n, 1)).astype(np.float32)
    h[min(3, n - 1)] = 0.0
    return torch.from_numpy(rgb).to(dev), torch.from_numpy(h).to(dev)


def _flat_patches(rng, n, hgt, wid):
    """Piecewise-constant 8 x 8 blocks of exact 0, 1 and two greys: many
    patch distances are exactly 0."""
    blocks = rng.choice(np.array([0.0, 1.0, 0.25, 0.625], np.float32),
                        (n, -(-hgt // 8), -(-wid // 8), 3))
    return np.ascontiguousarray(
        np.repeat(np.repeat(blocks, 8, 1), 8, 2)[:, :hgt, :wid])


def _nlm_cases(rng, dev, odd_gate):
    """(name, rgb, h, gate [N] numpy) of the NLM kernel checks: main
    [8,512,512,3] with 5 of 8 images on; odd [2,37,53,3]; flat
    [4,72,100,3], flat 8 x 8 patches with images at h = 0 and h = 1e-4 and
    one gated off; tiny [1,6,9,3], smaller than the 7-pixel halo."""
    import torch

    for name, gate, shape in (("main", MAIN_GATE, (8, 512, 512)),
                              ("odd", odd_gate, (2, 37, 53)),
                              ("tiny", [1.0], (1, 6, 9))):
        rgb, h = _nlm_inputs(rng, *shape, dev)
        yield name, rgb, h, np.asarray(gate, np.float32)
    rgb = torch.from_numpy(_flat_patches(rng, 4, 72, 100)).to(dev)
    h = torch.tensor([[0.0], [1e-4], [0.3], [0.5]], device=dev)
    yield "flat", rgb, h, np.array([1, 1, 0.5, 0], np.float32)


def phase_kernel_bwd():
    """K2 against its plain twin (autograd of the plain chain) on the card,
    with v = g * clip-gradient mask of U for a seeded normal g."""
    import torch

    from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray_bwd, nlm_gray_fwd
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray_bwd_plain
    from adaptiveisp_tpu_torch.ops.math import clip_grad_mask

    dev = torch.device("cuda")
    rng = np.random.RandomState(10)
    result = {}
    for name, rgb, h, gate_np in _nlm_cases(rng, dev, [1, 0.3]):
        n, hgt, wid, _ = rgb.shape
        gate = torch.from_numpy(gate_np[:, None]).to(dev)
        u, wsum = nlm_gray_fwd(rgb, h, gate)
        g = torch.from_numpy(rng.randn(n, hgt, wid, 3).astype(np.float32))
        v = (g.to(dev) * clip_grad_mask(u, 0.0, 1.0)).contiguous()
        dr, dhh = nlm_gray_bwd(rgb, h, gate, v, u, wsum)
        torch.cuda.synchronize()
        dr_p, dhh_p = nlm_gray_bwd_plain(rgb, h, gate, v)
        err_dr = float((dr - dr_p).abs().max())
        err_dh = float((dhh - dhh_p).abs().max())
        dh_ok = bool(torch.all((dhh - dhh_p).abs()
                               <= 1e-5 + 2e-4 * dhh_p.abs()))
        off = torch.from_numpy(gate_np == 0).to(dev)
        off_zero = bool(not torch.any(dr[off]) and not torch.any(dhh[off]))
        ok = err_dr <= 2e-5 and dh_ok and off_zero
        rec = {"phase": "kernel", "kernel": "nlm_gray_bwd", "case": name,
               "shape": [n, hgt, wid, 3], "gate": gate_np.tolist(),
               "max_abs_err_drgb": err_dr, "max_abs_err_dhh": err_dh,
               "max_abs_drgb": float(dr_p.abs().max()),
               "dhh": dhh.flatten().tolist(),
               "gated_off_exact_zero": off_zero,
               "tolerance": {"drgb_atol": 2e-5, "dhh_rtol": 2e-4,
                             "dhh_atol": 1e-5}, "ok": ok}
        if name == "main":
            rec["ms"] = cuda_time_ms(
                lambda: nlm_gray_bwd(rgb, h, gate, v, u, wsum), 50)
            rec["plain_ms"] = cuda_time_ms(
                lambda: nlm_gray_bwd_plain(rgb, h, gate, v), 5)
            rec.update(nlm_bwd_bound(int((gate_np != 0).sum()), n, hgt, wid))
        emit(rec)
        if not ok:
            raise AssertionError(f"nlm backward kernel disagrees with its "
                                 f"plain version ({name})")
        result[name] = rec
    return result


def phase_kernel():
    """K1 against its plain version on the card, and ``sym=True`` (JAX's
    K3, served by K1) bit for bit against ``sym=False``; in the main case
    the two timed in turns (sym=False, sym=True, sym=True, sym=False), and
    the wrapper against the registered operator ``nlm_gray`` that the port
    calls (``op_ms``: the operator's dispatch added), in turns too."""
    import torch

    from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray_fwd, nlm_gray_op
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray_uw

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    result = {}
    for name, rgb, h, gate_np in _nlm_cases(rng, dev, [1, 0]):
        n, hgt, wid, _ = rgb.shape
        gate = torch.from_numpy(gate_np[:, None]).to(dev)
        u, w = nlm_gray_fwd(rgb, h, gate)
        u3, w3 = nlm_gray_fwd(rgb, h, gate, sym=True)
        torch.cuda.synchronize()
        u_p, w_p = nlm_gray_uw(rgb, h)
        on = (gate != 0).reshape(n, 1, 1, 1)
        u_p = torch.where(on, u_p, 0.0)
        w_p = torch.where(on, w_p, 0.0)
        err_out = float((u.clamp(0, 1) - u_p.clamp(0, 1)).abs().max())
        err_u = float((u - u_p).abs().max())
        rel_w = float(((w - w_p).abs() / w_p.abs().clamp_min(1e-30))
                      [on.expand_as(w)].max())
        off = ~on.reshape(n)
        off_zero = bool(not torch.any(u[off]) and not torch.any(w[off]))
        sym_equal = bool(torch.equal(u3, u) and torch.equal(w3, w))
        ok = (err_out <= 2e-5 and err_u <= 2e-5 and rel_w <= 1e-5
              and off_zero and sym_equal)
        rec = {"phase": "kernel", "kernel": "nlm_gray_fwd", "case": name,
               "shape": [n, hgt, wid, 3], "gate": gate_np.tolist(),
               "max_abs_err_out": err_out, "max_abs_err_u": err_u,
               "max_rel_err_w": rel_w, "gated_off_exact_zero": off_zero,
               "sym_bit_equal": sym_equal,
               "tolerance": {"out_atol": 2e-5, "u_atol": 2e-5,
                             "w_rtol": 1e-5, "sym_vs_base": 0}, "ok": ok}
        if name == "main":
            turns = [cuda_time_ms(lambda sym=sym: nlm_gray_fwd(
                rgb, h, gate, sym=sym), 50) for sym in (False, True, True,
                                                         False)]
            # the registered operator (the one route the port takes to K1)
            # against the bare wrapper, in turns
            calls = (lambda: nlm_gray_fwd(rgb, h, gate),
                     lambda: nlm_gray_op(rgb, h, gate, False))
            op_turns = [cuda_time_ms(calls[k], 50) for k in (0, 1, 1, 0)]
            rec.update({"ms": float(np.median([turns[0], turns[3]])),
                        "sym_ms": float(np.median(turns[1:3])),
                        "op_ms": float(np.median(op_turns[1:3])),
                        "ms_turns": {"sym_false": [turns[0], turns[3]],
                                     "sym_true": turns[1:3],
                                     "wrapper": [op_turns[0], op_turns[3]],
                                     "op": op_turns[1:3]},
                        "plain_ms": cuda_time_ms(
                            lambda: nlm_gray_uw(rgb, h), 20)})
            rec.update(nlm_bound(int((gate_np != 0).sum()), n, hgt, wid))
        emit(rec)
        if not ok:
            raise AssertionError(f"nlm kernel disagrees with its plain "
                                 f"version or sym=True with sym=False "
                                 f"({name})")
        result[name] = rec
    return result


# stage -> least FP32 operations per pixel (all three channels) and the
# special-function-unit share of them, for the K4 bound
STAGE_OPS = {
    "exposure": (3, 0), "improved_wb": (3, 0), "ccm": (15, 0),
    "gamma": (12, 6),          # max, log, multiply, exp per channel
    "tone": (123, 0),          # 8 x (subtract, clip 2, multiply-add 2) + 1
    "color": (123, 0),
    "contrast": (30, 4),       # luminance, clip, cos, 3 divides, 3 lerps
    "wnb": (14, 0),
    "saturation_plus": (60, 4),
    "sharpen": (66, 0),        # 3 x (9 multiply-adds, mix, clip)
    "sharpen_v2": (66, 0),
}
PIPE_REPS = 50


def pipeline_bound(names, n: int, h: int, w: int, n_params: int):
    """K4 for these inputs: the image read once and written once (24 bytes
    a pixel) and one parameter row per image read once; per pixel the least
    arithmetic of each stage (STAGE_OPS)."""
    px = n * h * w
    ops = sum(STAGE_OPS[nm][0] for nm in names)
    sfu = sum(STAGE_OPS[nm][1] for nm in names)
    return bound(px * 24 + n * n_params * 4, px * ops, px * sfu)


def kernel_time_ms(launch, reps: int):
    """Median device time of the kernel alone over reps launches: each
    launch is queued while the card still writes a 128 MB buffer, so the
    start event is stamped as that write ends and the kernel reads past a
    flushed 50 MB L2, as a render of a fresh frame does."""
    import torch

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    times = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(float(i))
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _stages_5(n, rng):
    """The JAX bench's 5-stage render (``bench.py:170-178``), each image's
    parameters drawn within 20 % of the bench's."""
    base = [("exposure", [1.2]), ("improved_wb", [2.40, 1.22, 1.88]),
            ("ccm", list((np.eye(3) * 1.2).reshape(9))), ("gamma", [0.45]),
            ("sharpen", [3.0])]
    return [(nm, (np.asarray(p, np.float32)[None]
                  * rng.uniform(0.8, 1.2, (n, len(p)))).astype(np.float32))
            for nm, p in base]


def _pointwise_stack(n, rng):
    return [(nm, np.asarray(p, np.float32)) for nm, p in (
        ("tone", rng.uniform(0.5, 2.0, (n, 8))),
        ("color", rng.uniform(0.9, 1.1, (n, 8, 3))),
        ("contrast", rng.uniform(0.2, 0.6, (n, 1))),
        ("wnb", rng.uniform(0.1, 0.4, (n, 1))),
        ("saturation_plus", rng.uniform(0.3, 0.8, (n, 1))),
        ("improved_wb", rng.uniform(0.8, 1.2, (n, 3))),
        ("gamma", rng.uniform(0.6, 1.4, (n, 1))),
        ("exposure", rng.uniform(-0.5, 0.5, (n, 1))),
        ("ccm", np.eye(3).reshape(1, 9) + rng.uniform(-0.1, 0.1, (n, 9))))]


def _sharpen4(n, rng):
    """Four sharpen / sharpen_v2 stages interleaved with pointwise ones."""
    return [(nm, (np.asarray(p, np.float32)[None]
                  * rng.uniform(0.9, 1.1, (n, len(p)))).astype(np.float32))
            for nm, p in (("exposure", [0.3]), ("sharpen", [1.5]),
                          ("wnb", [0.3]), ("sharpen_v2", [0.6]),
                          ("gamma", [0.8]), ("sharpen", [0.7]),
                          ("contrast", [0.4]), ("sharpen_v2", [0.3]),
                          ("improved_wb", [1.1, 0.9, 1.0]))]


def _special_pixels(rng, n, h, w):
    """Values below 0 and above 1 with bands of exact 0, exact 1, grey
    (max == min) and two-channel ties (r == g, g == b, b == r)."""
    img = rng.uniform(-0.2, 1.2, (n, h, w, 3)).astype(np.float32)
    band = h // 8
    img[:, :band] = 0.0
    img[:, band:2 * band] = 1.0
    img[:, 2 * band:3 * band] = rng.rand(n, band, w, 1)
    for k, (a, b) in enumerate(((0, 1), (1, 2), (2, 0))):
        rows = slice((3 + k) * band, (4 + k) * band)
        img[:, rows, :, b] = img[:, rows, :, a]
    return img


def phase_kernel_pipeline():
    """K4 against its plain version (``render_pipeline(...,
    allow_fused=False)``) on the card; the timed cases as the kernel alone
    (:func:`kernel_time_ms`) and as the call; one profiled call."""
    import torch

    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops.bank import render_pipeline
    from adaptiveisp_tpu_torch.ops.cuda import pipeline as cp

    cfg = Config()
    dev = torch.device("cuda")
    rng = np.random.RandomState(30)
    cases = {
        "main": (rng.rand(SERVE_BATCH, SERVE_SIZE, SERVE_SIZE, 3).astype(
            np.float32), _stages_5(SERVE_BATCH, rng)),
        "pointwise_special": (_special_pixels(rng, 2, 256, 384),
                              _pointwise_stack(2, rng)),
        "sharpen4_odd": (rng.uniform(-0.1, 1.1, (2, 37, 53, 3)).astype(
            np.float32), _sharpen4(2, rng)),
        "sharpen4_tiny": (rng.uniform(-0.1, 1.1, (1, 6, 9, 3)).astype(
            np.float32), _sharpen4(1, rng)),
        "sharpen4_4k": (rng.rand(1, *UHD, 3).astype(np.float32),
                        _sharpen4(1, rng)),
        "pointwise_4k": (rng.uniform(-0.1, 1.1, (1, *UHD, 3)).astype(
            np.float32), _pointwise_stack(1, rng)),
    }
    timed = ("main", "sharpen4_4k", "pointwise_4k")
    result = {}
    for name, (img_np, stages_np) in cases.items():
        img = torch.from_numpy(img_np).to(dev)
        stages = [(nm, torch.from_numpy(p).to(dev)) for nm, p in stages_np]
        got = cp.render_pipeline_fused(cfg, img, stages)
        torch.cuda.synchronize()
        want = render_pipeline(cfg, img, stages, allow_fused=False)
        diff = (got - want).abs()
        over = int((diff > 2e-5 + 2e-4 * want.abs()).sum())
        ok = over == 0 and bool(torch.isfinite(got).all())
        names = [nm for nm, _ in stages]
        rec = {"phase": "kernel", "kernel": "pipeline_fwd", "case": name,
               "shape": list(img.shape), "stages": names,
               "max_abs_err": float(diff.max()),
               "max_rel_err": float((diff / want.abs().clamp_min(1e-6))
                                    .max()),
               "outside_tolerance": over,
               "tolerance": {"rtol": 2e-4, "atol": 2e-5}, "ok": ok}
        del got, want, diff
        if name in timed:
            args, _, rows = cp.launch_args(cfg, img, stages)
            entry = cp._entry()
            rec["kernel_ms"] = kernel_time_ms(lambda: entry(*args),
                                              PIPE_REPS)
            rec["call_ms"] = cuda_time_ms(
                lambda: cp.render_pipeline_fused(cfg, img, stages),
                PIPE_REPS)
            rec["call_host_us"] = host_time_us(
                lambda: cp.render_pipeline_fused(cfg, img, stages))
            rec["ms"] = rec["kernel_ms"]
            rec["plain_ms"] = cuda_time_ms(
                lambda: render_pipeline(cfg, img, stages, allow_fused=False),
                20)
            n, h, w, _ = img.shape
            rec.update(pipeline_bound(names, n, h, w,
                                      cp.chain(cfg, names).n_params))
            del args, rows
        if name == "main":
            rec["profile"] = profile_fused_call(cfg, img, stages)
            ok = ok and rec["profile"]["only_k4"]
            rec["ok"] = ok
        emit(rec)
        if not ok:
            raise AssertionError(f"render kernel disagrees with its plain "
                                 f"version or its call did other device "
                                 f"work ({name})")
        result[name] = rec
    return result


def host_time_us(call, reps: int = 200):
    """Host time of one call (microseconds), from reps calls queued back to
    back (their launches run behind them on the card)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def profile_fused_call(cfg, img, stages):
    """Device work of one ``render_pipeline_fused`` call (torch.profiler):
    only K4 is expected (the output's allocation is no device work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adaptiveisp_tpu_torch.ops.cuda.pipeline import render_pipeline_fused

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_pipeline_fused(cfg, img, stages)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    return {"device_events": [{"name": k[1][:90], "us": k[0], "count": k[2]}
                              for k in kernels],
            "only_k4": (len(kernels) == 1 and kernels[0][2] == 1
                        and "_kernel" in kernels[0][1])}


def phase_kernel_sym_path():
    """The path of JAX's K3 in the port: the registered operator
    ``nlm_gray`` with ``sym=True`` forward and backward once (K1, then K2),
    launch counts read around it, against autograd of the plain chain."""
    import torch

    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray as nlm_op
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray

    dev = torch.device("cuda")
    rng = np.random.RandomState(40)
    rgb, h = _nlm_inputs(rng, 2, 64, 96, dev)
    g = torch.from_numpy(rng.randn(2, 64, 96, 3).astype(np.float32)).to(dev)
    gate = torch.ones((2, 1), device=dev)
    x = rgb.clone().requires_grad_(True)
    hk = h.clone().requires_grad_(True)
    torch.cuda.synchronize()
    build.reset_launches()
    out = nlm_op(x, hk, gate, True)
    out.backward(g)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    xp = rgb.clone().requires_grad_(True)
    hp = h.clone().requires_grad_(True)
    out_p = nlm_gray(xp, hp)
    out_p.backward(g)
    err_out = float((out - out_p).detach().abs().max())
    err_dr = float((x.grad - xp.grad).abs().max())
    dh_ok = bool(torch.all((hk.grad - hp.grad).abs()
                           <= 1e-5 + 2e-4 * hp.grad.abs()))
    ok = (launches == only(nlm_gray_fwd=1, nlm_gray_bwd=1)
          and err_out <= 2e-5 and err_dr <= 2e-5 and dh_ok)
    emit({"phase": "kernel_sym_path", "shape": [2, 64, 96, 3],
          "launches": launches, "max_abs_err_out": err_out,
          "max_abs_err_drgb": err_dr, "dh": hk.grad.flatten().tolist(),
          "dh_plain": hp.grad.flatten().tolist(),
          "tolerance": {"out_atol": 2e-5, "drgb_atol": 2e-5,
                        "dh_rtol": 2e-4, "dh_atol": 1e-5}, "ok": ok})
    if not ok:
        raise AssertionError("nlm_gray(sym=True) disagrees with the plain "
                             "chain or launched the wrong kernels")
    return launches


RENDER_SCRIPT = [("exposure", [0.35]), ("improved_wb", [1.05, 0.95, 1.02]),
                 ("denoise", [0.25]), ("gamma", [0.9]), ("sharpen", [1.6]),
                 ("saturation_plus", [0.6])]
RENDER_REPS = 20


def phase_render():
    """The scripted render through its entry point: ``render_isp.main`` on
    8 seeded 512 x 512 PNGs at ``--batch 8`` with a chain split by denoise
    (two fusable runs: K4 twice, K1 once); every saved PNG against the
    port's CPU chain of the same frame; launch counts read around the run.
    Then ``render_pipeline`` timed directly (CUDA events) for the bench's
    5-stage chain at batch 8 @ 512 and 2 x 2160 x 3840, and for the split
    chain at batch 8 @ 512, beside the eager chain (allow_fused=False)."""
    import shutil
    from pathlib import Path

    import torch
    import yaml
    from PIL import Image

    from adaptiveisp_tpu_torch import render_isp
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.data.sources import load_image_file
    from adaptiveisp_tpu_torch.ops.bank import render_pipeline
    from adaptiveisp_tpu_torch.ops.cuda import build

    root = Path(__file__).resolve().parent / "build" / "render_smoke"
    shutil.rmtree(root, ignore_errors=True)
    (root / "imgs").mkdir(parents=True)
    rng = np.random.RandomState(50)
    for i in range(SERVE_BATCH):
        Image.fromarray((rng.rand(SERVE_SIZE, SERVE_SIZE, 3) * 255).astype(
            np.uint8)).save(root / "imgs" / f"im{i}.png")
    with open(root / "chain.yaml", "w") as f:
        yaml.safe_dump([{"name": n, "params": p} for n, p in RENDER_SCRIPT],
                       f)
    args = ["--source", str(root / "imgs"), "--script",
            str(root / "chain.yaml"), "--batch", str(SERVE_BATCH),
            "--exist-ok"]
    render_isp.main(args + ["--out", str(root / "warm")])
    torch.cuda.synchronize()

    # ---- the main path: launch counts read around exactly this run ----
    build.reset_launches()
    t0 = time.perf_counter()
    out_dir = render_isp.main(args + ["--out", str(root / "out")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)

    cfg = Config()
    cpu_stages = [(n, torch.tensor([p], dtype=torch.float32))
                  for n, p in RENDER_SCRIPT]
    frames = np.stack([load_image_file(str(root / "imgs" / f"im{i}.png"))
                       for i in range(SERVE_BATCH)])
    with torch.no_grad():
        want = render_pipeline(cfg, torch.from_numpy(frames), [
            (n, p.expand(SERVE_BATCH, -1)) for n, p in cpu_stages]).numpy()
    want = np.clip(want, 0.0, 1.0)
    got = np.stack([np.asarray(Image.open(Path(out_dir) / f"im{i}.png"),
                               np.float32) / 255.0
                    for i in range(SERVE_BATCH)])
    err = float(np.abs(got - want).max())
    tol = 1.0 / 255 + 5e-5
    ok_counts = launches == only(pipeline_fwd=2, nlm_gray_fwd=1)
    rec = {"phase": "render", "entry": "render_isp.main", "batch":
           SERVE_BATCH, "size": SERVE_SIZE,
           "chain": [n for n, _ in RENDER_SCRIPT], "launches": launches,
           "expected_launches": {"pipeline_fwd": 2, "nlm_gray_fwd": 1},
           "cli_wall_s": wall, "png_max_abs_err_vs_cpu": err,
           "png_tolerance": tol, "ok": ok_counts and err <= tol}

    dev = torch.device("cuda")
    timed = {}
    cases = {"bench5_b8_512": (SERVE_BATCH, SERVE_SIZE, SERVE_SIZE, None),
             "bench5_b2_2160x3840": (2, *UHD, None),
             "split_b8_512": (SERVE_BATCH, SERVE_SIZE, SERVE_SIZE,
                              RENDER_SCRIPT)}
    for label, (n, hgt, wid, script) in cases.items():
        img = torch.from_numpy(rng.rand(n, hgt, wid, 3).astype(
            np.float32)).to(dev)
        if script is None:
            stages = [(nm, torch.from_numpy(p).to(dev))
                      for nm, p in _stages_5(n, rng)]
        else:
            stages = [(nm, torch.tensor([p], device=dev).expand(n, -1))
                      for nm, p in script]
        with torch.no_grad():
            render_pipeline(cfg, img, stages)
            ms = cuda_time_ms(lambda: render_pipeline(cfg, img, stages),
                              RENDER_REPS)
            eager = cuda_time_ms(lambda: render_pipeline(
                cfg, img, stages, allow_fused=False), 5)
        mpix = n * hgt * wid / 1e6
        timed[label] = {"shape": [n, hgt, wid, 3], "ms": ms,
                        "mpix_per_s": mpix / (ms / 1e3), "eager_ms": eager,
                        "eager_mpix_per_s": mpix / (eager / 1e3)}
    rec["timed"] = timed
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"render path: launches {launches} (expected "
                             f"2 K4 and 1 K1), PNG error {err} > {tol}")
    return launches


def phase_fused_grad():
    """One ``fused_run`` gradient on the card (K4 forward; backward through
    the eager chain) at batch 2 @ 128 px, with respect to the image and
    each stage's parameters, against autograd of the plain chain."""
    import torch

    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.bank import render_pipeline
    from adaptiveisp_tpu_torch.ops.cuda.pipeline import fused_run

    cfg = Config()
    dev = torch.device("cuda")
    rng = np.random.RandomState(60)
    img = rng.uniform(0.02, 0.98, (2, 128, 128, 3)).astype(np.float32)
    stages = _stages_5(2, rng)
    g = torch.from_numpy(rng.randn(*img.shape).astype(np.float32)).to(dev)
    grads, outs = [], []
    for fused in (True, False):
        x = torch.from_numpy(img).to(dev).requires_grad_(True)
        ps = [torch.from_numpy(p).to(dev).requires_grad_(True)
              for _, p in stages]
        names = [nm for nm, _ in stages]
        build.reset_launches()
        stages_t = list(zip(names, ps))
        out = (fused_run(cfg, x, stages_t) if fused
               else render_pipeline(cfg, x, stages_t, allow_fused=False))
        out.backward(g)
        torch.cuda.synchronize()
        if fused:
            launches = dict(build.LAUNCHES)
        outs.append(out.detach())
        grads.append([x.grad] + [p.grad for p in ps])
    errs = {}
    ok = launches == only(pipeline_fwd=1)
    for key, a, b in zip(["img"] + [nm for nm, _ in stages], *grads):
        errs[key] = float((a - b).abs().max() / (b.abs().max() + 1e-12))
        ok = ok and bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6))
    diff = (outs[0] - outs[1]).abs()
    err_out = float(diff.max())
    ok = ok and bool(torch.all(diff <= 2e-5 + 2e-4 * outs[1].abs()))
    emit({"phase": "fused_grad", "shape": list(img.shape),
          "stages": [nm for nm, _ in stages], "launches": launches,
          "max_abs_err_out": err_out, "grad_rel_err": errs,
          "tolerance": {"rtol": 1e-5, "atol": 1e-6}, "ok": ok})
    if not ok:
        raise AssertionError("fused_run gradient disagrees with the plain "
                             "chain")


def phase_serving():
    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.ops.cuda import build

    cfg = Config()
    isp = api.load_adaptive_isp(cfg=cfg, steps=STEPS, seed=0, device="cuda")
    det = api.load_detector(spec=YOLOV3_SPEC, seed=0, device="cuda")
    images = torch.from_numpy(np.random.RandomState(1).rand(
        SERVE_BATCH, SERVE_SIZE, SERVE_SIZE, 3).astype(np.float32)).cuda()
    nms = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True)

    def serve(pipeline):
        out = isp.process(images, pipeline=pipeline, seed=2)
        return out, det.detect(out, **nms)

    for pipe in (FORCED, None):  # warm-up: cuDNN plans, kernel load
        serve(pipe)
    torch.cuda.synchronize()

    # ---- the main path: launch counts read around exactly this run ----
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for label, pipe in (("forced_denoise", FORCED), ("free", None)):
        roll_ms, det_ms = [], []
        for _ in range(REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            out = isp.process(images, pipeline=pipe, seed=2)
            ev[1].record()
            dets, n_valid = det.detect(out, **nms)
            ev[2].record()
            ev[2].synchronize()
            roll_ms.append(ev[0].elapsed_time(ev[1]))
            det_ms.append(ev[1].elapsed_time(ev[2]))
        ok = (tuple(out.shape) == tuple(images.shape)
              and bool(torch.isfinite(out).all())
              and float(out.min()) >= 0.0 and float(out.max()) <= 1.0
              and tuple(dets.shape) == (SERVE_BATCH, 300, 6)
              and bool(torch.isfinite(dets).all()))
        rms, dms = float(np.median(roll_ms)), float(np.median(det_ms))
        runs[label] = {"rollout_ms": rms, "detect_nms_ms": dms,
                       "batch_ms": rms + dms,
                       "images_per_s": SERVE_BATCH / ((rms + dms) / 1e3),
                       "detections": int(n_valid.sum()), "ok": ok}
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expected = STEPS * REPS * 2
    emit({"phase": "serving", "batch": SERVE_BATCH, "size": SERVE_SIZE,
          "steps": STEPS, "render": "blend", "detector": "yolov3",
          "nms": nms, "reps": REPS, "runs": runs, "launches": launches,
          "expected_nlm_launches": expected,
          "max_memory_allocated": peak})
    if launches["nlm_gray_fwd"] != expected:
        raise AssertionError(f"NLM kernel launched {launches} times, "
                             f"expected {expected} (5 per process call)")
    if not all(r["ok"] for r in runs.values()):
        raise AssertionError("serving outputs malformed")

    # ---- step 0 against the port's own CPU run of the first 2 images ----
    res = isp.process_with_trace(images, pipeline=FORCED, seed=3)
    cpu = api.load_adaptive_isp(cfg=cfg, steps=1, seed=0, device="cpu")
    res_cpu = cpu.process_with_trace(images[:2].cpu(), pipeline=FORCED[:1],
                                     seed=3)
    step0 = res.images_per_step[0, :2].cpu()
    err = float((step0 - res_cpu.images_per_step[0]).abs().max())
    same_sel = bool((res.selected[0, :2].cpu() == res_cpu.selected[0]).all())
    ok = err <= 1e-4 and same_sel
    emit({"phase": "serving_vs_cpu", "step0_max_abs_err": err,
          "atol": 1e-4, "selected_equal": same_sel, "ok": ok})
    if not ok:
        raise AssertionError("step-0 images disagree with the CPU run")
    phase_serving_map(cfg, isp, images[:2], nms)
    phase_profile(isp, det, images, nms, runs["forced_denoise"]["batch_ms"])
    return launches


def spread_detector_state(spec, seed: int):
    """Seeded YOLOv3 weights that keep activations of order 1 through the
    depth (convolutions normal with variance 1 / fan-in, BatchNorm scales
    and variances in [0.5, 1.5], other parameters normal with scale 0.1), as
    the port's CPU tests seed theirs, so that the head's scores spread and
    which boxes NMS keeps is not a tie-break that float32 noise decides.
    torch's default initialisation saturated the head (its top 400 scores
    of an image took 3 distinct values); these weights do not depend on
    the constructor's initialisation."""
    import torch

    from adaptiveisp_tpu_torch.detect.model import DetectionModel

    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in DetectionModel(spec).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            a = v.numpy()
        elif v.ndim == 4:
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith(("running_var", "bn.weight")):
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.randn(*shape) * 0.1
        sd[k] = torch.from_numpy(np.asarray(a, v.numpy().dtype))
    return sd


def phase_serving_map(cfg, isp, images, nms):
    """mAP of the served chain on the card against the port's CPU chain
    (the same agent and noise, 2 images at 512 px, then YOLOv3 with
    ``spread_detector_state`` weights on each): labels are the CPU chain's
    top 4 detections of each image, jittered by up to 3 px, so mAP sits
    well above 0 and drift between the chains shows."""
    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.detect import metrics
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC

    sd = spread_detector_state(YOLOV3_SPEC, 7)
    det = api.load_detector(spec=YOLOV3_SPEC, device="cuda", state_dict=sd)
    det_cpu = api.load_detector(spec=YOLOV3_SPEC, device="cpu", state_dict=sd)
    isp_cpu = api.load_adaptive_isp(cfg=cfg, steps=STEPS, seed=0, device="cpu")
    out_g = isp.process(images, seed=4)
    out_c = isp_cpu.process(images.cpu(), seed=4)
    dets_g, n_g = (a.cpu().numpy() for a in det.detect(out_g, **nms))
    dets_c, n_c = (a.numpy() for a in det_cpu.detect(out_c, **nms))
    iouv = np.linspace(0.5, 0.95, 10)
    jitter = np.random.RandomState(6)
    stats_g, stats_c = [], []
    for b in range(images.shape[0]):
        d_g, d_c = dets_g[b, :n_g[b]], dets_c[b, :n_c[b]]
        top = d_c[np.argsort(-d_c[:, 4], kind="stable")[:4]]
        labels = np.concatenate(
            [top[:, 5:6], top[:, :4] + jitter.uniform(-3, 3, (4, 4))], 1)
        for d, st in ((d_g, stats_g), (d_c, stats_c)):
            st.append((metrics.process_batch(d, labels, iouv), d[:, 4],
                       d[:, 5], labels[:, 0]))
    m_g, m_c = metrics.summarize(stats_g), metrics.summarize(stats_c)
    keys = ("precision", "recall", "map50", "map")
    d50, dmap = (abs(m_g[k] - m_c[k]) for k in ("map50", "map"))
    ok = m_c["map50"] > 0.3 and d50 < 0.01 and dmap < 0.01
    emit({"phase": "serving_map", "images": int(images.shape[0]),
          "nms": nms, "detections_card": n_g.tolist(),
          "detections_cpu": n_c.tolist(),
          "card": {k: m_g[k] for k in keys},
          "cpu": {k: m_c[k] for k in keys},
          "abs_diff": {"map50": d50, "map": dmap}, "atol": 0.01, "ok": ok})
    if not ok:
        raise AssertionError("mAP on the card disagrees with the CPU's")


def device_kernels(prof):
    """(device us, name, count) of each kernel in a torch.profiler run,
    largest first; the device-side ranges of user annotations (such as
    ``Optimizer.step``) are spans, not kernels, and are left out."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0), reverse=True)


def phase_profile(isp, det, images, nms, batch_ms):
    """Where one forced batch's device time goes: kernel time by name
    (torch.profiler), its share of the unprofiled batch time, and the
    detector forward against NMS (CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adaptiveisp_tpu_torch.detect.model import decode_predictions
    from adaptiveisp_tpu_torch.detect.nms import non_max_suppression

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = isp.process(images, pipeline=FORCED, seed=2)
        det.detect(out, **nms)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3
    flops = []

    def count(mod, inp, outp):  # 2 * MACs of each convolution
        flops.append(2 * outp.numel() * mod.weight[0].numel())

    hooks = [m.register_forward_hook(count) for m in det.model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        ev[0].record()
        preds = decode_predictions(det.model(out), det.spec)
        ev[1].record()
        non_max_suppression(preds, **nms)
        ev[2].record()
    ev[2].synchronize()
    for h in hooks:
        h.remove()
    detector_ms = ev[0].elapsed_time(ev[1])
    emit({"phase": "profile", "batch": "forced_denoise",
          "device_kernel_ms": device_ms or None,
          "device_busy_share": (device_ms / batch_ms) if device_ms else None,
          "kernel_launches": sum(k[2] for k in kernels),
          "detector_ms": detector_ms, "detector_gflop": sum(flops) / 1e9,
          "detector_tflop_per_s": sum(flops) / detector_ms / 1e9,
          "nms_ms": ev[1].elapsed_time(ev[2]),
          "top_kernels": [{"name": k[1][:90], "ms": k[0] / 1e3,
                           "count": k[2]} for k in kernels[:15]]})


def _train_setup(cfg, tcfg, size, batch, dtype, device, seed=0):
    """Seeded agent, critic and frozen YOLOv3 through the api loaders, the
    train step and its state, and a seeded batch with padded targets (a
    few boxes per image, t_max 64)."""
    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.detect.loss import pad_targets
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.train.optim import make_optimizer
    from adaptiveisp_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )
    from adaptiveisp_tpu_torch.train.trainer import imgsz_hyp

    agent = api.load_adaptive_isp(cfg=cfg, seed=seed, device=device).agent
    value = api.load_value(cfg, seed=seed + 1, device=device)
    det = api.load_detector(spec=YOLOV3_SPEC, seed=seed + 2, device=device,
                            dtype=dtype)
    tx = make_optimizer(tcfg.lr, tcfg.max_iter_step, tcfg.grad_clip_norm,
                        tcfg.lr_decay, tcfg.lr_segments)
    state = init_train_state(agent, value, tx, tx)
    step = make_train_step(det.model, cfg, tcfg,
                           anchors_in_grid_units(YOLOV3_SPEC),
                           imgsz_hyp(size, YOLOV3_SPEC["nc"],
                                     len(YOLOV3_SPEC["anchors"])))
    rng = np.random.RandomState(seed + 20)
    imgs = rng.rand(batch, size, size, 3).astype(np.float32)
    z = rng.rand(batch, cfg.z_dim).astype(np.float32)
    states = np.zeros((batch, cfg.num_state_dim), np.float32)
    labels = []
    for _ in range(batch):
        k = rng.randint(2, 6)
        xy = rng.uniform(0.2, 0.8, (k, 2))
        wh = rng.uniform(0.05, 0.4, (k, 2))
        labels.append(np.concatenate(
            [rng.randint(0, YOLOV3_SPEC["nc"], (k, 1)), xy, wh], 1))
    targets, tmask = pad_targets(labels, 64)
    tensors = [torch.from_numpy(a).to(device)
               for a in (imgs, z, states, targets, tmask)]
    return state, step, tensors


def phase_train(dtype_name: str):
    """TRAIN_WARMUP + TRAIN_STEPS steps of the full-width train step; the
    launch counts are reset after the warm-up and read after the timed
    steps."""
    import torch

    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.ops.cuda import build

    dtype = torch.bfloat16 if dtype_name == "bf16" else None
    cfg, tcfg = Config(), TrainConfig(batch_size=SERVE_BATCH)
    state, step, batch = _train_setup(cfg, tcfg, SERVE_SIZE, SERVE_BATCH,
                                      dtype, "cuda")
    gen = torch.Generator(device="cuda")
    before = [p.detach().clone() for p in state.agent.parameters()]
    names = ("agent", "detector", "critic", "backward", "optimizer")
    for i in range(TRAIN_WARMUP):
        gen.manual_seed(i)
        step(state, batch, gen, 0.0)
        if i == 0:   # Adam's first update is lr * g / (|g| + eps) < lr
            delta = max(float((p.detach() - b).abs().max())
                        for p, b in zip(state.agent.parameters(), before))
    torch.cuda.synchronize()
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms, parts = [], {k: [] for k in names}
    for i in range(TRAIN_STEPS):
        gen.manual_seed(TRAIN_WARMUP + i)
        ev = {"start": torch.cuda.Event(enable_timing=True)}
        ev["start"].record()

        def mark(name, ev=ev):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        out = step(state, batch, gen, (TRAIN_WARMUP + i) / 100.0, mark)
        ev["optimizer"].synchronize()
        prev = "start"
        for k in names:
            parts[k].append(ev[prev].elapsed_time(ev[k]))
            prev = k
        step_ms.append(ev["start"].elapsed_time(ev["optimizer"]))
    launches = dict(build.LAUNCHES)
    m = {k: v.float().cpu().numpy().tolist() for k, v in out.metrics.items()}
    finite = all(np.isfinite(np.asarray(v, np.float64)).all()
                 for k, v in m.items() if k != "selected_filter")
    rec = {"phase": "train", "detector_dtype": dtype_name,
           "batch": SERVE_BATCH, "size": SERVE_SIZE, "detector": "yolov3",
           "cached_input_loss": False, "warmup": TRAIN_WARMUP,
           "steps": TRAIN_STEPS, "step_ms": float(np.median(step_ms)),
           "step_ms_all": step_ms,
           "split_ms": {k: float(np.median(v)) for k, v in parts.items()},
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "state_step": state.step,
           "first_update_max_abs": delta, "lr": tcfg.lr, "metrics": m,
           "metrics_finite": finite}
    emit(rec)
    if launches != only(nlm_gray_fwd=TRAIN_STEPS, nlm_gray_bwd=TRAIN_STEPS):
        raise AssertionError(f"train launches {launches}, expected one K1 "
                             f"and one K2 launch per step")
    if not finite or state.step != TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError("train step metrics not finite or step count "
                             "wrong")
    if not 0.0 < delta < tcfg.lr:
        raise AssertionError(f"first update {delta} not in (0, {tcfg.lr})")
    if dtype_name == "bf16":
        phase_train_profile(state, step, batch, gen, rec["step_ms"])
    return rec


def phase_train_profile(state, step, batch, gen, step_ms):
    """Kernel time by name over one bf16 train step (torch.profiler) and
    its share of the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen, 0.5)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3
    emit({"phase": "train_profile", "detector_dtype": "bf16",
          "device_kernel_ms": device_ms or None,
          "device_busy_share": (device_ms / step_ms) if device_ms else None,
          "kernel_launches": sum(k[2] for k in kernels),
          "top_kernels": [{"name": k[1][:90], "ms": k[0] / 1e3,
                           "count": k[2]} for k in kernels[:15]]})


def phase_train_vs_cpu():
    """One f32 step at batch 2 @ 128 px with the full YOLOv3 on the card (K1
    and K2) and on the port's own CPU run (plain versions), same weights and
    batch, dropout off; z steers image 0 onto denoise so K2 does real work.
    detect_loss_weight 0.05 and no truncation keep the reward's and the
    critic's gradients on the render path."""
    import copy

    import torch

    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.ops.cuda import build

    cfg = Config(dropout_keep_prob=1.0, detect_loss_weight=0.05)
    tcfg = TrainConfig(batch_size=2, use_truncated=False)
    denoise = cfg.filters.index("denoise")
    state_c, step_c, batch_c = _train_setup(cfg, tcfg, 128, 2, None, "cpu",
                                            seed=5)
    probe = copy.deepcopy(state_c.agent).train()
    with torch.no_grad():
        pdf = probe(*batch_c[:3], 0.0, train=True)[5]["pdf"][0]
    batch_c[1][0, 0] = pdf[:denoise].sum() + 0.5 * pdf[denoise]
    state_g, step_g, _ = _train_setup(cfg, tcfg, 128, 2, None, "cuda",
                                      seed=5)
    batch_g = [t.cuda() for t in batch_c]
    sd0 = {k: v.clone() for k, v in state_c.agent.state_dict().items()}
    build.reset_launches()
    out_g = step_g(state_g, batch_g, None, 0.0)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    out_c = step_c(state_c, batch_c, None, 0.0)
    errs = {}
    for k, v in out_c.metrics.items():
        a, b = out_g.metrics[k].float().cpu(), v.float()
        errs[k] = float((a - b).abs().max() / (b.abs().max() + 1e-6))
    par = {}
    for net in ("agent", "value"):
        sd_g = getattr(state_g, net).state_dict()
        sd_c = getattr(state_c, net).state_dict()
        par[net] = max(float((sd_g[k].cpu() - sd_c[k]).abs().max())
                       for k in sd_c if sd_c[k].is_floating_point())
    nlm_moved = float((state_c.agent.state_dict()["NLM.fc_filter.weight"]
                       - sd0["NLM.fc_filter.weight"]).abs().max())
    sel = out_g.metrics["selected_filter"].cpu().tolist()
    # an Adam step moves a parameter by about lr = 3e-5 at most: 5 % of one
    # step covers float32 differences between cuDNN's and the CPU's
    # convolutions; metrics (the reward is 100x a loss difference) to 1e-3
    ok = (errs and max(errs.values()) <= 1e-3 and par["agent"] <= 1.5e-6
          and par["value"] <= 1.5e-6 and sel[0] == denoise and nlm_moved > 0
          and launches == only(nlm_gray_fwd=1, nlm_gray_bwd=1))
    emit({"phase": "train_vs_cpu", "batch": 2, "size": 128,
          "selected_filter": sel, "launches": launches,
          "metric_rel_err": errs, "param_max_abs_diff": par, "lr": tcfg.lr,
          "nlm_head_update": nlm_moved,
          "tolerance": {"metric_rtol": 1e-3, "param_atol": 1.5e-6},
          "ok": ok})
    if not ok:
        raise AssertionError("train step on the card disagrees with the CPU")


def _trainer_data():
    """64 seeded 512 x 512 PNGs with 2-5 YOLO boxes each, a list of 8 of
    them for validation, and a data YAML (source ``normalize``, the LOD
    layout) under build/train_smoke."""
    import shutil
    from pathlib import Path

    import yaml
    from PIL import Image

    root = Path(__file__).resolve().parent / "build" / "train_smoke"
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.RandomState(60)
    for i in range(TRAINER_IMAGES):
        base = rng.rand(1, 1, 3) * 0.5 + 0.1
        img = np.clip(base + rng.rand(SERVE_SIZE, SERVE_SIZE, 3) * 0.4, 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            root / "images" / f"{i}.png")
        k = rng.randint(2, 6)
        rows = np.concatenate([rng.randint(0, 80, (k, 1)),
                               rng.uniform(0.25, 0.75, (k, 2)),
                               rng.uniform(0.05, 0.4, (k, 2))], 1)
        (root / "labels" / f"{i}.txt").write_text(
            "".join(" ".join(f"{v:.6f}" for v in r) + "\n" for r in rows))
    (root / "val.txt").write_text("".join(
        f"images/{i}.png\n" for i in range(TRAINER_VAL)))
    (root / "data.yaml").write_text(yaml.safe_dump({
        "path": str(root), "train": "images", "val": "val.txt", "nc": 80,
        "source": "normalize"}))
    return root


def _payload_diffs(got, want, path=""):
    """Paths where two checkpoint payloads differ (tensors bit for bit)."""
    import torch

    if isinstance(want, torch.Tensor):
        ok = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
              and got.device == want.device and torch.equal(got, want))
        return [] if ok else [path]
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [path]
        return [d for k in want for d in _payload_diffs(got[k], want[k],
                                                        f"{path}/{k}")]
    return [] if got == want else [path]


def phase_trainer(smi):
    """The RL trainer loop at full width on the card (module docstring,
    phase 8)."""
    import contextlib
    import os

    import torch

    from adaptiveisp_tpu_torch import train_isp
    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.data import native
    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train import checkpoint as ckpt_lib
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    root = _trainer_data()
    data = check_dataset(str(root / "data.yaml"))
    cfg = Config(save_model_freq=10, val_freq=10)
    tcfg = TrainConfig(batch_size=SERVE_BATCH, imgsz=SERVE_SIZE)
    kw = dict(data_source=data["source"], yolo_dtype="bfloat16",
              device_replay=True, cached_reward=True, device="cuda")
    names = ("sample", "agent", "detector", "critic", "backward",
             "optimizer", "writeback", "validate", "end")
    iters = []

    def mark(name):
        if name == "start":
            iters.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        iters[-1][name] = (ev, time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, data["train"], val_path=data["val"],
                 save_dir=str(root / "exp"), **kw)
    resumed = None
    try:
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pool_bytes = tr.device_replay.images.numel() * 4
        tr.train(max_steps=TRAINER_WARMUP - 1)
        torch.cuda.synchronize()
        build.reset_launches()
        refreshes0 = tr.device_replay.refreshes
        fresh0 = tr.device_replay.fresh_images
        tr.train(max_steps=TRAINER_WARMUP + TRAINER_ITERS - 1, mark=mark)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        split = {k: [] for k in names}   # "end": the checkpoint
        iter_ms = []
        for ev in iters:
            prev = "start"
            for k in names:
                split[k].append(ev[prev][0].elapsed_time(ev[k][0]))
                prev = k
            iter_ms.append((ev["end"][1] - ev["start"][1]) * 1e3)
        med = float(np.median(iter_ms))
        steps_ms = [sum(split[k][i] for k in names[1:6])
                    for i in range(len(iters))]
        hist = tr.history[TRAINER_WARMUP:]
        finite = bool(np.isfinite([[h[k] for k in h] for h in hist]).all())
        val_files = sorted(f for f in os.listdir(tr.image_dir)
                           if f.endswith("_steps.png"))

        # ---- the final state saved, then resumed into a second Trainer --
        ckpt_step = ckpt_lib.latest_step(tr.ckpt_dir)   # the automatic one
        final_dir = str(root / "exp" / "ckpt_final")
        ckpt_lib.save(final_dir, tr.state, tr.state.step)
        resumed = Trainer(cfg, tcfg, data["train"],
                          save_dir=str(root / "exp_resumed"), log=False,
                          **kw)
        resumed.resume(final_dir)
        diffs = _payload_diffs(ckpt_lib.payload(resumed.state),
                               ckpt_lib.payload(tr.state))
    finally:
        tr.close()
        if resumed is not None:
            resumed.close()
    n_val = len(val_files)
    expected = only(nlm_gray_fwd=TRAINER_ITERS + 2 * 2 * STEPS,
                    nlm_gray_bwd=TRAINER_ITERS)
    rec = {"phase": "trainer", "nvidia_smi": smi,
           "batch": SERVE_BATCH, "size": SERVE_SIZE, "detector": "yolov3",
           "detector_dtype": "bf16", "roster": list(cfg.filters),
           "pool_slots": cfg.replay_memory_size, "pool_bytes": pool_bytes,
           "cached_reward": True, "train_images": TRAINER_IMAGES,
           "val_images": TRAINER_VAL, "warmup": TRAINER_WARMUP,
           "iterations": len(iters), "build_s": build_s,
           "iteration_ms": med, "iteration_ms_mean": float(np.mean(iter_ms)),
           "iteration_ms_all": iter_ms, "iterations_per_s": 1e3 / med,
           "split_ms": {k: float(np.median(v)) for k, v in split.items()},
           "split_ms_max": {k: float(np.max(v)) for k, v in split.items()},
           "step_ms": float(np.median(steps_ms)),
           "refreshes": tr.device_replay.refreshes - refreshes0,
           "fresh_images_decoded": tr.device_replay.fresh_images - fresh0,
           "divergence_count": tr.divergence_count,
           "launches": launches, "expected_launches": expected,
           "max_memory_allocated": peak, "preprocess": native.backend(),
           "state_step": tr.state.step, "history_finite": finite,
           "validation_strips": val_files,
           "checkpoint_step": ckpt_step,
           "resumed_step": resumed.state.step,
           "resume_diffs": diffs[:10], "resume_bit_equal": not diffs}
    emit(rec)
    if launches != expected:
        raise AssertionError(f"trainer launches {launches}, expected "
                             f"{expected}")
    if launches["nlm_gray_fwd"] == 0 or launches["nlm_gray_bwd"] == 0:
        raise AssertionError("K1 or K2 not launched by the trainer")
    if not finite or tr.state.step != TRAINER_WARMUP + TRAINER_ITERS:
        raise AssertionError("trainer history not finite or step wrong")
    if n_val != 4 or ckpt_step != 20 or diffs:
        raise AssertionError(f"validation strips {val_files}, checkpoint "
                             f"{ckpt_step}, resume diffs {diffs[:10]}")

    # ---- the CLI: 2 iterations with the device pool, then the host pool
    cli = {}
    args = ["--task", "train", "--data_cfg", str(root / "data.yaml"),
            "--batch_size", str(SERVE_BATCH), "--imgsz", str(SERVE_SIZE),
            "--max_steps", "1", "--device", "cuda",
            "--weights", str(root / "no_detector_weights.pt")]
    cwd = os.getcwd()
    for label, extra in (("train_isp", []),
                         ("train_isp_host_pool", ["--no_device_replay"])):
        build.reset_launches()
        t0 = time.perf_counter()
        os.chdir(root)   # the CLI writes experiments/ under its cwd
        try:
            with contextlib.redirect_stderr(sys.stdout):
                cli_tr = train_isp.main(args + extra)
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        cli[label] = {"seconds": time.perf_counter() - t0,
                      "launches": dict(build.LAUNCHES),
                      "state_step": cli_tr.state.step,
                      "device_pool": cli_tr.device_replay is not None,
                      "history": cli_tr.history}
    emit({"phase": "trainer_cli", **cli})
    for label, r in cli.items():
        if (r["state_step"] != 2
                or r["launches"] != only(nlm_gray_fwd=2, nlm_gray_bwd=2)
                or r["device_pool"] != (label == "train_isp")
                or not np.isfinite([h["agent_loss"]
                                    for h in r["history"]]).all()):
            raise AssertionError(f"{label}: {r}")
    return rec, {k: r["launches"] for k, r in cli.items()}


def _force_refreshes(pool):
    """A stopped trajectory and a diverged batch, written back into fixed
    slots of a device pool: both refresh their slots from the feeder (one
    upload, ``index_copy_``, the cached losses seeded on the device)."""
    import torch

    from adaptiveisp_tpu_torch.policy.states import (
        STATE_STEP_DIM,
        STATE_STOPPED_DIM,
    )

    idx = np.array([0, 5])
    rows = torch.as_tensor(idx, device=pool.images.device)
    new_states = pool.states[idx].copy()
    new_states[0, STATE_STOPPED_DIM] = 1   # slot 0 stops: refreshed
    new_states[1, STATE_STEP_DIM] = 0      # slot 5 is kept, written back
    pool.replace(idx, pool.images.index_select(0, rows) * 0.5, new_states,
                 retouch_loss=pool.loss_in.index_select(0, rows) + 1.0)
    pool.replace(np.array([7, 12]), None, None, diverged=True)


def phase_trainer_vs_cpu():
    """The same seeded Trainer on the card and on the CPU (module
    docstring, phase 9)."""
    import torch

    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_TINY_SPEC
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    root = _trainer_data()
    data = check_dataset(str(root / "data.yaml"))
    cfg = Config(dropout_keep_prob=1.0, replay_memory_size=16)
    tcfg = TrainConfig(batch_size=2, imgsz=128)
    runs = {}
    for device in ("cuda", "cpu"):
        build.reset_launches()
        tr = Trainer(cfg, tcfg, data["train"],
                     save_dir=str(root / f"exp_{device}"), log=False,
                     yolo_spec=YOLOV3_TINY_SPEC, yolo_dtype="float32",
                     device_replay=True, cached_reward=True,
                     data_source=data["source"], device=device)
        pool = tr.device_replay
        seen, sample = [], pool.sample

        def recorded(n, sample=sample, seen=seen):
            out = sample(n)
            seen.append((out[0].tolist(), out[2].tolist()))
            return out

        pool.sample = recorded
        try:
            tr.train(max_steps=2)
            _force_refreshes(pool)
            tr.train(max_steps=3)   # samples the refreshed pool
        finally:
            tr.close()
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = {"seen": seen, "history": tr.history,
                        "states": pool.states.tolist(),
                        "images": pool.images.cpu(),
                        "loss_in": pool.loss_in.cpu(),
                        "meta": [(m["path"], m["label"].tolist(), m["shape"])
                                 for m in pool.meta],
                        "refreshes": pool.refreshes,
                        "fresh_images": pool.fresh_images,
                        "launches": dict(build.LAUNCHES)}
    g, c = runs["cuda"], runs["cpu"]
    # each metric's largest difference over its largest magnitude
    rel = {k: max(abs(hg[k] - hc[k])
                  for hg, hc in zip(g["history"], c["history"]))
           / (max(abs(hc[k]) for hc in c["history"]) + 1e-6)
           for k in c["history"][0]}
    image_err = float((g["images"] - c["images"]).abs().max())
    loss_rel = float((g["loss_in"] - c["loss_in"]).abs().max()
                     / (c["loss_in"].abs().max() + 1e-6))
    pool_ok = (g["meta"] == c["meta"] and image_err <= 1e-3
               and loss_rel <= 1e-3 and g["refreshes"] == c["refreshes"] >= 3
               and g["fresh_images"] == c["fresh_images"])
    ok = (g["seen"] == c["seen"] and g["states"] == c["states"]
          and len(g["history"]) == len(c["history"]) == 4
          and max(rel.values()) <= 1e-3 and pool_ok
          and g["launches"] == only(nlm_gray_fwd=4, nlm_gray_bwd=4))
    emit({"phase": "trainer_vs_cpu", "batch": 2, "size": 128,
          "detector": "yolov3-tiny", "iterations": 4,
          "sampled_equal": g["seen"] == c["seen"],
          "states_equal": g["states"] == c["states"],
          "sampled_slots": [s[0] for s in g["seen"]],
          "history_rel_err": rel, "rtol": 1e-3,
          "refreshes": [g["refreshes"], c["refreshes"]],
          "fresh_images": [g["fresh_images"], c["fresh_images"]],
          "pool_meta_equal": g["meta"] == c["meta"],
          "pool_image_max_abs_err": image_err, "pool_image_atol": 1e-3,
          "pool_loss_rel_err": loss_rel, "pool_loss_rtol": 1e-3,
          "launches_card": g["launches"], "ok": ok})
    if not ok:
        raise AssertionError("the trainer on the card disagrees with the "
                             "CPU's")


VAL_PROTOCOL = dict(steps=STEPS, conf_thres=0.001, iou_thres=0.6,
                    max_det=300)
# the validation runs: the reference protocol at batch 1 (switch render)
# free and with denoise forced first (4 images: the free run picks denoise
# at nearly every step already), the blend at batch 8, and batch 1 with
# merge-NMS and TTA (2 images: its CPU reference runs 3 detector passes an
# image)
VAL_RUNS = {"b1_free": dict(batch_size=1),
            "b1_forced": dict(batch_size=1, pipeline=FORCED, max_images=4),
            "b8_blend": dict(batch_size=SERVE_BATCH),
            "b1_merge_tta": dict(batch_size=1, merge=True, augment=True,
                                 max_images=2)}
HR_SIZES = ((512, 683), (341, 512))   # (h, w): capped to 384 x 512, odd
FIXED_CHAIN = ("exposure", "denoise", "gamma", "sharpen")
FIXED_STEPS, FIXED_BATCHES = 12, 4
# the optimiser held against the CPU at 512 px: 3 steps (one luminance
# step, two of the full chain) at batch 2 (the shared denoise strength
# sums two images' gradients)
FIXED_CMP_BATCH, FIXED_CMP_STEPS = 2, 3
FIVE_STAGES = ("exposure", "improved_wb", "ccm", "gamma", "sharpen")


def _eval_models(device, det_sd):
    """The seeded agent (Config() roster) and YOLOv3 with ``det_sd``."""
    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC

    cfg = Config()
    return (cfg, api.load_adaptive_isp(cfg=cfg, seed=0, device=device).agent,
            api.load_detector(spec=YOLOV3_SPEC, device=device,
                              state_dict=det_sd).model)


def _labelled_val_set(cfg, agent, yolo, data):
    """The trainer data's validation images under build/val_smoke, each
    labelled with its top 4 detections of a free batch-1 validation run on
    the card, jittered by up to 3 px (normalised coordinates clipped to
    [0.001, 0.999]), so that mAP sits well above 0 and
    drift between card and CPU shows.  Returns the data YAML's path."""
    import shutil

    import yaml

    from adaptiveisp_tpu_torch.data.datasets import ISPDataset
    from adaptiveisp_tpu_torch.eval.validator import run_validation

    root = Path(__file__).resolve().parent / "build" / "val_smoke"
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    ds = ISPDataset(data["val"], img_size=SERVE_SIZE, source="normalize",
                    train=False)
    run_validation(cfg, agent, yolo, ds, **VAL_PROTOCOL, batch_size=1,
                   save_dir=str(root / "seed"), save_txt=True,
                   save_conf=True)
    jitter = np.random.RandomState(6)
    for path in ds.im_files:
        stem = Path(path).stem
        shutil.copy(path, root / "images")
        rows = np.loadtxt(root / "seed" / "labels" / f"{stem}.txt",
                          ndmin=2)
        top = rows[np.argsort(-rows[:, 5], kind="stable")[:4], :5]
        top[:, 1:] = np.clip(top[:, 1:] + jitter.uniform(
            -3, 3, (len(top), 4)) / SERVE_SIZE, 1e-3, 1 - 1e-3)
        (root / "labels" / f"{stem}.txt").write_text("".join(
            f"{int(r[0])} " + " ".join(f"{v:.6f}" for v in r[1:]) + "\n"
            for r in top))
    (root / "data.yaml").write_text(yaml.safe_dump({
        "path": str(root), "train": "images", "val": "images", "nc": 80,
        "source": "normalize"}))
    return root / "data.yaml"


def _host_reads(cfg, agent, yolo, ds):
    """The free batch-1 run with the host's reads of device values timed:
    each ``bool`` or ``int`` of a tensor inside the rollout (early exit,
    the switch render's filter id) or inside NMS (its block loop) waits
    for the card to finish the work queued before it.  Returns the reads'
    count and blocked ms per image, by place, and the run's wall ms per
    image."""
    import torch

    from adaptiveisp_tpu_torch.eval import validator

    where = [None]
    blocked = {"rollout": [0, 0.0], "nms": [0, 0.0]}

    def timed(read):
        def wrapper(t):
            if where[0] is None:
                return read(t)
            t0 = time.perf_counter()
            out = read(t)
            blocked[where[0]][0] += 1
            blocked[where[0]][1] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    def scoped(name, fn):
        def wrapper(*a, **k):
            where[0] = name
            try:
                return fn(*a, **k)
            finally:
                where[0] = None
        return wrapper

    saved = (torch.Tensor.__bool__, torch.Tensor.__int__,
             validator.rollout, validator.non_max_suppression)
    torch.Tensor.__bool__ = timed(saved[0])
    torch.Tensor.__int__ = timed(saved[1])
    validator.rollout = scoped("rollout", saved[2])
    validator.non_max_suppression = scoped("nms", saved[3])
    try:
        r = validator.run_validation(cfg, agent, yolo, ds, **VAL_PROTOCOL,
                                     batch_size=1)
    finally:
        (torch.Tensor.__bool__, torch.Tensor.__int__, validator.rollout,
         validator.non_max_suppression) = saved
    n = len(ds)
    wall = r["wall_ms_per_img"]
    return {"wall_ms_per_img": wall, "speed": r["speed"],
            **{f"{k}_reads_per_img": v[0] / n for k, v in blocked.items()},
            **{f"{k}_blocked_ms_per_img": v[1] / n
               for k, v in blocked.items()},
            "blocked_share": sum(v[1] for v in blocked.values()) / n / wall}


def phase_validation(smi):
    """``run_validation`` at the reference protocol (512 px, 5 steps, conf
    0.001, IoU 0.6, max_det 300), Config() agent and full YOLOv3 with
    ``spread_detector_state`` weights, on the trainer data's 8 validation
    PNGs labelled by ``_labelled_val_set``: each run of VAL_RUNS on the
    card (launch counts read around it) and on the CPU, records equal,
    mAP50 and mAP within 0.01.  Then one profiled batch-1 run: device
    kernel time against its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.data.datasets import ISPDataset
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.eval.validator import run_validation
    from adaptiveisp_tpu_torch.ops.cuda import build

    det_sd = spread_detector_state(YOLOV3_SPEC, 7)
    cfg, agent, yolo = _eval_models("cuda", det_sd)
    _, agent_c, yolo_c = _eval_models("cpu", det_sd)
    data_yaml = _labelled_val_set(
        cfg, agent, yolo, check_dataset(str(_trainer_data() / "data.yaml")))
    ds = ISPDataset(check_dataset(str(data_yaml))["val"], img_size=SERVE_SIZE,
                    source="normalize", train=False)
    runs, launches = {}, {}
    for name, kw in VAL_RUNS.items():
        build.reset_launches()
        r = run_validation(cfg, agent, yolo, ds, **VAL_PROTOCOL, **kw)
        torch.cuda.synchronize()
        launches[name] = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        rc = run_validation(cfg, agent_c, yolo_c, ds, **VAL_PROTOCOL, **kw)
        diff = {k: abs(r[k] - rc[k]) for k in ("map50", "map")}
        runs[name] = {
            "speed": r["speed"], "wall_ms_per_img": r["wall_ms_per_img"],
            "launches": launches[name], "records": r["records"],
            "records_equal": r["records"] == rc["records"],
            "card": {k: r[k] for k in ("precision", "recall", "map50",
                                       "map")},
            "cpu": {k: rc[k] for k in ("map50", "map")}, "abs_diff": diff,
            "cpu_seconds": time.perf_counter() - t0,
            "ok": (r["records"] == rc["records"]
                   and len(r["records"]) == kw.get("max_images", len(ds))
                   and max(diff.values()) < 0.01)}
    # the speed report's split with each bucket waiting for the card
    synced = {f"b{b}": run_validation(cfg, agent, yolo, ds, **VAL_PROTOCOL,
                                      batch_size=b, profile=True)["speed"]
              for b in (1, SERVE_BATCH)}
    reads = _host_reads(cfg, agent, yolo, ds)
    # ---- the batch-1 run once more under the profiler: busy share ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rp = run_validation(cfg, agent, yolo, ds, **VAL_PROTOCOL,
                            batch_size=1)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3
    emit({"phase": "validation", "nvidia_smi": smi, "images": len(ds),
          "size": SERVE_SIZE, "detector": "yolov3", "protocol": VAL_PROTOCOL,
          "runs": runs, "speed_synced": synced, "host_reads_b1": reads,
          "profile_b1": {"wall_ms": wall_ms, "ms_per_img": wall_ms / len(ds),
                         "device_kernel_ms": device_ms or None,
                         "device_busy_share": (device_ms / wall_ms
                                               if device_ms else None),
                         "kernel_launches": sum(k[2] for k in kernels),
                         "records_equal": rp["records"]
                         == runs["b1_free"]["records"],
                         "top_kernels": [{"name": k[1][:90],
                                          "ms": k[0] / 1e3, "count": k[2]}
                                         for k in kernels[:10]]}})
    bad = [n for n, r in runs.items() if not r["ok"]]
    if runs["b1_free"]["card"]["map50"] < 0.3:
        bad.append("b1_free: mAP50 against its own labels under 0.3")
    if bad:
        raise AssertionError(f"validation on the card disagrees with the "
                             f"CPU in {bad}")
    if (launches["b1_forced"]["nlm_gray_fwd"]
            < VAL_RUNS["b1_forced"]["max_images"]
            or launches["b8_blend"]["nlm_gray_fwd"] == 0):
        raise AssertionError(f"K1 not launched by the validator: {launches}")
    return agent, det_sd, data_yaml, runs["b1_free"]["records"], launches


def phase_val_cli(agent, det_sd, data_yaml, records):
    """``val_isp.main`` on the same data, the validation phase's agent and
    detector weights (written to files), with every artifact switched on
    but the plots (the card's machine has no matplotlib): the artifacts
    exist and the records equal the validation phase's."""
    import contextlib
    import shutil

    import torch

    from adaptiveisp_tpu_torch import val_isp
    from adaptiveisp_tpu_torch.ops.cuda import build

    out = data_yaml.parent / "val_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir()
    torch.save({"agent_model": agent.state_dict()}, out / "agent.pt")
    torch.save(det_sd, out / "yolov3.pt")
    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = val_isp.main([
            "--data", str(data_yaml), "--weights",
            str(out / "yolov3.pt"), "--isp_weights", str(out / "agent.pt"),
            "--imgsz", str(SERVE_SIZE), "--device", "cuda", "--save_image",
            "--save_param", "--save_txt", "--save_json",
            "--project", str(out), "--name", "exp"])
    torch.cuda.synchronize()
    exp = out / "exp"
    counts = {d: len(list((exp / d).rglob("*.*")))
              for d in ("img_results", "param_results", "labels")}
    have = {f: (exp / f).exists() for f in ("records.txt",
                                            "predictions.json")}
    rec = {"phase": "val_cli", "seconds": time.perf_counter() - t0,
           "launches": dict(build.LAUNCHES), "speed": res["speed"],
           "wall_ms_per_img": res["wall_ms_per_img"],
           "map50": res["map50"], "artifact_counts": counts,
           "artifacts": have, "records_equal": res["records"] == records}
    emit(rec)
    if (not rec["records_equal"] or not all(have.values())
            or counts != {"img_results": TRAINER_VAL * STEPS,
                          "param_results": TRAINER_VAL,
                          "labels": TRAINER_VAL}):
        raise AssertionError(f"val_isp: {rec}")
    return rec["launches"]


def _hr_data(root):
    """Two seeded non-square PNGs (683 x 512 and 512 x 341) with a box
    each, and a data YAML, under root."""
    import shutil

    import yaml
    from PIL import Image

    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.RandomState(61)
    for i, (h, w) in enumerate(HR_SIZES):
        img = np.clip(rng.rand(1, 1, 3) * 0.4 + rng.rand(h, w, 3) * 0.5, 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            root / "images" / f"{i}.png")
        (root / "labels" / f"{i}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    (root / "data.yaml").write_text(yaml.safe_dump({
        "path": str(root), "train": "images", "val": "images", "nc": 80,
        "source": "normalize"}))
    return root


def phase_hr_render(agent):
    """``run_hr_validation`` on HR_SIZES frames (capped at 512: 384 x 512
    and the odd 341 x 512), the validation phase's agent from a
    weights-only file, on the card and on the CPU: per-step frames before
    PNG quantisation within 1e-4, the same frames written (early stops);
    then ``train_isp.main(["--task", "val", ...])`` on the card."""
    import torch

    from adaptiveisp_tpu_torch import train_isp
    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.eval import hr_render
    from adaptiveisp_tpu_torch.ops.cuda import build

    root = _hr_data(Path(__file__).resolve().parent / "build" / "hr_smoke")
    weights = root / "agent.pt"
    torch.save({"agent_model": agent.state_dict()}, weights)
    data = check_dataset(str(root / "data.yaml"))
    cfg, tcfg = Config(), TrainConfig(batch_size=1, imgsz=SERVE_SIZE)
    saved = hr_render.save_img
    frames = {}

    def capture(img, path):
        frames[device][os.path.relpath(path, out_dir)] = np.array(img)
        saved(img, path)

    hr_render.save_img = capture
    try:
        for device in ("cuda", "cpu"):
            frames[device] = {}
            out_dir = root / f"out_{device}" / "val-images"
            build.reset_launches()
            t0 = time.perf_counter()
            hr_render.run_hr_validation(cfg, tcfg, data, str(weights),
                                        str(out_dir.parent), steps=STEPS,
                                        device=device)
            if device == "cuda":
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = dict(build.LAUNCHES)
    finally:
        hr_render.save_img = saved
    g, c = frames["cuda"], frames["cpu"]
    keys_g, keys_c = sorted(g), sorted(c)
    errs = {k: float(np.abs(g[k] - c[k]).max()) for k in keys_c if k in g}
    shapes = sorted({tuple(v.shape) for k, v in g.items()
                     if k.startswith("step-")})
    want_shapes = sorted((round(h * SERVE_SIZE / max(h, w)),
                          round(w * SERVE_SIZE / max(h, w)), 3)
                         for h, w in HR_SIZES)
    n_steps = sum(k.startswith("step-") for k in g)
    build.reset_launches()
    t0 = time.perf_counter()
    out_dir = train_isp.main([
        "--task", "val", "--data_cfg", str(root / "data.yaml"),
        "--model_weights", str(weights), "--imgsz", str(SERVE_SIZE),
        "--device", "cuda", "--val_save_path", str(root / "train_isp_val")])
    torch.cuda.synchronize()
    cli = {"seconds": time.perf_counter() - t0,
           "launches": dict(build.LAUNCHES),
           "frames": sorted(str(p.relative_to(out_dir))
                            for p in Path(out_dir).rglob("*.png"))}
    ok = (keys_g == keys_c and len(errs) == len(keys_c)
          and max(errs.values()) <= 1e-4 and launches["nlm_gray_fwd"] > 0
          and shapes == want_shapes and cli["frames"] == keys_c)
    emit({"phase": "hr_render", "frames_hw": [list(s[:2]) for s in shapes],
          "images": len(HR_SIZES), "step_frames": n_steps,
          "card_seconds": secs, "ms_per_image": secs * 1e3 / len(HR_SIZES),
          "ms_per_step_frame": secs * 1e3 / max(n_steps, 1),
          "launches": launches, "max_abs_err": max(errs.values()),
          "atol": 1e-4, "frames_equal": keys_g == keys_c,
          "train_isp_val": cli, "ok": ok})
    if not ok:
        raise AssertionError("hr_render on the card disagrees with the CPU "
                             "or train_isp --task val wrote other frames")
    return launches, cli["launches"]


def _fixed_batches(device, n, size, seed):
    """FIXED_BATCHES seeded dark (LOD-like) batches of n images with 2-5
    boxes each: (images, targets, tmask) on device."""
    import torch

    from adaptiveisp_tpu_torch.detect.loss import pad_targets

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(FIXED_BATCHES):
        imgs = (rng.rand(n, size, size, 3) * 0.15).astype(np.float32)
        labels = []
        for _ in range(n):
            k = rng.randint(2, 6)
            labels.append(np.concatenate(
                [rng.randint(0, 80, (k, 1)), rng.uniform(0.25, 0.75, (k, 2)),
                 rng.uniform(0.05, 0.4, (k, 2))], 1))
        out.append(tuple(torch.from_numpy(a).to(device) for a in
                         (imgs, *pad_targets(labels, 64))))
    return out


def _fixed_run(device, det_sd, n, size, steps):
    """optimize_fixed_pipeline over FIXED_CHAIN with the full YOLOv3
    (``det_sd``) on ``device``, launch counts read around it: (squashed,
    raw, history, seconds, launches, detector, batches)."""
    import contextlib

    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train.fixed_pipeline import (
        optimize_fixed_pipeline,
    )
    from adaptiveisp_tpu_torch.train.trainer import imgsz_hyp

    yolo = api.load_detector(spec=YOLOV3_SPEC, device=device,
                             state_dict=det_sd).model
    batches = _fixed_batches(api.resolve_device(device), n, size, 80)
    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out = optimize_fixed_pipeline(
            Config(), FIXED_CHAIN, yolo, anchors_in_grid_units(YOLOV3_SPEC),
            batches, hyp=imgsz_hyp(size), lr=3e-2, steps=steps)
    if device == "cuda":
        torch.cuda.synchronize()
    return (*out, time.perf_counter() - t0, dict(build.LAUNCHES), yolo,
            batches)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def phase_fixed_pipeline(smi, det_sd):
    """The fixed-pipeline optimiser (module docstring, phase 13)."""
    import torch

    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train.fixed_pipeline import (
        init_raw_params,
        make_fixed_pipeline_step,
    )
    from adaptiveisp_tpu_torch.train.optim import adam
    from adaptiveisp_tpu_torch.train.trainer import imgsz_hyp

    # ---- the main path: batch 8 @ 512 on the card ----
    stages, raw, hist, secs, launches, yolo, batches = _fixed_run(
        "cuda", det_sd, SERVE_BATCH, SERVE_SIZE, FIXED_STEPS)
    cfg, anchors, hyp = (Config(), anchors_in_grid_units(YOLOV3_SPEC),
                         imgsz_hyp(SERVE_SIZE))
    step, _ = make_fixed_pipeline_step(cfg, FIXED_CHAIN, yolo, anchors, hyp,
                                       allow_fused=False)
    dev = batches[0][0].device
    r = init_raw_params(cfg, FIXED_CHAIN, device=dev)
    opt = adam(3e-2)(list(r.values()))
    step_ms = cuda_time_ms(lambda: step(r, opt, *batches[0]), REPS)

    # ---- card against the CPU: the same optimisation at 512 px, cut to
    # FIXED_CMP_STEPS steps at batch FIXED_CMP_BATCH ----
    cmp = {d: _fixed_run(d, det_sd, FIXED_CMP_BATCH, SERVE_SIZE,
                         FIXED_CMP_STEPS) for d in ("cuda", "cpu")}
    g, c = cmp["cuda"], cmp["cpu"]
    hist_rel = _rel_err(g[2], c[2])
    raw_err = max(float((g[1][k].cpu() - c[1][k]).abs().max())
                  for k in c[1])
    # how far the compared run moved its parameters (the check's scale)
    init = init_raw_params(cfg, FIXED_CHAIN)
    raw_moved = max(float((v - init[k]).abs().max()) for k, v in c[1].items())
    sq_err = max(float((a.cpu() - b).abs().max())
                 for (_, a), (_, b) in zip(g[0], c[0]))

    # ---- one step on the 5-stage chain: the fused render (K4 forward,
    # its gradient through the plain chain) against allow_fused=False ----
    rng = np.random.RandomState(81)
    raw0 = {k: v + torch.from_numpy(rng.normal(0, 0.3, v.shape).astype(
        np.float32)).to(dev) for k, v in init_raw_params(
        cfg, FIVE_STAGES, device=dev).items()}
    fused = {}
    for allow in (True, False):
        rr = {k: v.clone() for k, v in raw0.items()}
        st, _ = make_fixed_pipeline_step(cfg, FIVE_STAGES, yolo, anchors,
                                         hyp, allow_fused=allow)
        o = adam(3e-2)(list(rr.values()))
        build.reset_launches()
        loss = float(st(rr, o, *batches[1]))
        torch.cuda.synchronize()
        fused[allow] = (loss, {k: v.detach().cpu() for k, v in rr.items()},
                        dict(build.LAUNCHES))
    f_loss_rel = abs(fused[True][0] - fused[False][0]) / abs(fused[False][0])
    f_raw_err = max(float((fused[True][1][k] - fused[False][1][k]).abs()
                          .max()) for k in raw0)
    ok = (launches["nlm_gray_bwd"] >= FIXED_STEPS
          and launches["nlm_gray_fwd"] >= FIXED_STEPS
          and np.isfinite(hist).all() and hist_rel <= 1e-3
          and raw_err <= 1e-3 and sq_err <= 1e-3
          and g[4]["nlm_gray_bwd"] >= FIXED_CMP_STEPS
          and f_loss_rel <= 1e-5 and f_raw_err <= 1e-4
          and fused[True][2]["pipeline_fwd"] == 1
          and fused[False][2]["pipeline_fwd"] == 0)
    emit({"phase": "fixed_pipeline", "nvidia_smi": smi,
          "chain": list(FIXED_CHAIN), "batch": SERVE_BATCH,
          "size": SERVE_SIZE, "detector": "yolov3", "steps": FIXED_STEPS,
          "seconds": secs, "ms_per_step_with_evals": secs * 1e3 / FIXED_STEPS,
          "step_ms": step_ms, "history": hist, "launches": launches,
          "squashed": {n: p.cpu().reshape(-1).tolist() for n, p in stages},
          "vs_cpu": {"batch": FIXED_CMP_BATCH, "size": SERVE_SIZE,
                     "steps": FIXED_CMP_STEPS, "history": c[2],
                     "history_rel_err": hist_rel,
                     "raw_max_abs_err": raw_err, "raw_moved": raw_moved,
                     "squashed_max_abs_err": sq_err, "tol": 1e-3,
                     "card_seconds": g[3], "cpu_seconds": c[3],
                     "launches_card": g[4]},
          "fused_step": {"chain": list(FIVE_STAGES),
                         "loss": [fused[True][0], fused[False][0]],
                         "loss_rel_err": f_loss_rel,
                         "raw_max_abs_err": f_raw_err,
                         "launches": [fused[True][2], fused[False][2]]},
          "ok": ok})
    if not ok:
        raise AssertionError("fixed pipeline: K2 not launched each step, or "
                             "the card disagrees with the CPU, or the fused "
                             "step with the plain one")
    return launches, fused[True][2]


def _det_data():
    """DET_IMAGES seeded 640 x 640 synthetic-shapes PNGs for training and
    16 for validation, 2-5 filled rectangles each with a YOLO label of one
    of 80 classes, and a data YAML over the validation images, under
    build/det_smoke."""
    import shutil
    from pathlib import Path

    import yaml
    from PIL import Image

    root = Path(__file__).resolve().parent / "build" / "det_smoke"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(80)
    for split, n in (("train", DET_IMAGES), ("val", DET_VAL)):
        (root / split / "images").mkdir(parents=True)
        (root / split / "labels").mkdir()
        for i in range(n):
            s = DET_SIZE
            img = (rng.rand(1, 1, 3) * 0.4 + 0.3
                   + rng.rand(s, s, 3) * 0.2).astype(np.float32)
            rows = []
            for _ in range(rng.randint(2, 6)):
                w, h = rng.randint(s // 16, s * 2 // 5, 2)
                x0, y0 = rng.randint(0, s - w), rng.randint(0, s - h)
                c = rng.randint(0, 80)
                img[y0:y0 + h, x0:x0 + w] = rng.rand(3)
                rows.append(f"{c} {(x0 + w / 2) / s:.6f} {(y0 + h / 2) / s:.6f}"
                            f" {w / s:.6f} {h / s:.6f}\n")
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                root / split / "images" / f"{i}.png")
            (root / split / "labels" / f"{i}.txt").write_text("".join(rows))
    (root / "val.yaml").write_text(yaml.safe_dump({
        "path": str(root / "val"), "train": "images", "val": "images",
        "nc": 80, "source": "normalize"}))
    return root


def _state_snapshot(tr):
    """Host copies of a DetectorTrainer's model state, EMA and optimizer
    state."""
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    opt = tr.state.optimizer.state_dict()
    return {"model": cpu(tr.model.state_dict()),
            "ema": cpu(tr.state.ema.params),
            "opt": {str(i): s["trace"].cpu().clone()
                    for i, s in opt["state"].items()},
            "count": opt["count"], "step": tr.state.step,
            "updates": tr.state.ema.updates}


def phase_detector_train(smi):
    """Detector training at full width on the card: ``DetectorTrainer`` on
    full YOLOv3 (80 classes), 640 px, batch 16, f32, the default hyp
    (mosaic, HSV, flips, perspective), validation and checkpoints every
    epoch, for 2 epochs of 2 steps; each step timed by CUDA events (the
    step, its optimizer update and EMA apart), each batch's host data time
    by the host clock; then a second trainer resumed from the first
    epoch's checkpoint runs the second epoch, equal bit for bit (cuDNN
    deterministic in this phase)."""
    import contextlib

    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.detect.train_detector import DetTrainConfig
    from adaptiveisp_tpu_torch.detect.train_loop import DetectorTrainer

    root = _det_data()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = DetTrainConfig(epochs=DET_EPOCHS, batch_size=DET_BATCH)

    def trainer(save):
        tds = DetectorDataset(str(root / "train" / "images"),
                              img_size=DET_SIZE, batch_size=DET_BATCH,
                              augment=True, nc=80, seed=0)
        vds = DetectorDataset(str(root / "val" / "images"),
                              img_size=DET_SIZE, batch_size=DET_BATCH,
                              augment=False, nc=80)
        model = api.load_detector(spec=YOLOV3_SPEC, seed=0, device="cuda").model
        return DetectorTrainer(model, YOLOV3_SPEC, tds, vds, cfg=cfg,
                               save_dir=str(root / save), save_period=1,
                               device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = trainer("run")
    start = {k: v.detach().clone() for k, v in tr.state.ema.params.items()}
    events, data_ms, epoch_s, phase_s = [], [], [], {"val": [], "save": []}

    def timed_events(fn, name):
        def run(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            events.append((name, e0, e1))
            return out
        return run

    def timed_host(fn, sink):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sink.append(time.perf_counter() - t0)
            return out
        return run

    tr.step_fn = timed_events(tr.step_fn, "step")
    tr.state.optimizer.step = timed_events(tr.state.optimizer.step,
                                           "optimizer")
    tr.state.ema.update = timed_events(tr.state.ema.update, "ema")
    tr.train_ds.collate = timed_host(tr.train_ds.collate, data_ms)
    tr.train_epoch = timed_host(tr.train_epoch, epoch_s)
    tr._validate = timed_host(tr._validate, phase_s["val"])
    tr._save = timed_host(tr._save, phase_s["save"])
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        hist = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = {n: [e0.elapsed_time(e1) for m, e0, e1 in events if m == n]
          for n in ("step", "optimizer", "ema")}
    spe = DET_IMAGES // DET_BATCH
    step_med = float(np.median(ms["step"][1:]))
    busy = [sum(ms["step"][e * spe:(e + 1) * spe]) / 1e3 / epoch_s[e]
            for e in range(len(epoch_s))]
    final = _state_snapshot(tr)
    ema_moved = max(float((v.cpu() - start[k].cpu()).abs().max())
                    for k, v in tr.state.ema.params.items())
    losses = [h.loss for h in hist]

    # resume from the first epoch's checkpoint into a fresh trainer
    tr2 = trainer("resumed")
    ck = str(root / "run" / "epoch0.pt")
    with contextlib.redirect_stdout(sys.stderr):
        start_epoch = tr2.resume(ck)
        hist2 = tr2.fit()
    again = _state_snapshot(tr2)
    diffs = [f"{part}/{k}" for part in ("model", "ema", "opt")
             for k in final[part]
             if not torch.equal(final[part][k], again[part][k])]
    diffs += [k for k in ("count", "step", "updates") if final[k] != again[k]]
    torch.backends.cudnn.deterministic = False
    rec = {"phase": "detector_train", "nvidia_smi": smi,
           "spec": "yolov3", "imgsz": DET_SIZE, "batch": DET_BATCH,
           "epochs": DET_EPOCHS, "steps_per_epoch": spe,
           "params": sum(p.numel() for p in tr.model.parameters()),
           "losses": losses, "map50": [h.metrics["map50"] for h in hist],
           "step_ms": ms["step"], "step_ms_median_after_first": step_med,
           "images_per_s": DET_BATCH * 1e3 / step_med,
           "optimizer_ms_median": float(np.median(ms["optimizer"])),
           "ema_ms_median": float(np.median(ms["ema"])),
           "host_data_ms_per_batch": [d * 1e3 for d in data_ms],
           "host_data_ms_median": float(np.median(data_ms)) * 1e3,
           "epoch_train_s": epoch_s, "busy_share": busy,
           "validation_s": phase_s["val"], "checkpoint_s": phase_s["save"],
           "fit_s": fit_s, "peak_gb": peak / 1e9, "ema_moved": ema_moved,
           "resume_start_epoch": start_epoch,
           "resume_losses": [h.loss for h in hist2],
           "resume_equal": not diffs, "resume_diffs": diffs[:10]}
    emit(rec)
    if (not all(np.isfinite(losses)) or ema_moved <= 0 or diffs
            or start_epoch != 1 or len(ms["step"]) != DET_EPOCHS * spe
            or [h.loss for h in hist2] != losses[1:]):
        raise AssertionError(f"detector_train: {rec}")
    return rec


def phase_detector_vs_cpu():
    """The same full YOLOv3 at batch 2 @ 256 px, augmentation off, two
    train steps (``make_detector_train_step`` with the warmup optimizer:
    the biases at lr 0.1, the kernels at 0 then 3.3e-5) on the card and on
    the CPU from one state.  Tolerances: loss 1e-4 relative; conv kernels
    and BatchNorm weights 1e-5 of their largest value (their updates are
    lr 3.3e-5 times the gradient, so a gradient's float32 error of 1e-3
    relative moves them 3e-8); biases and BatchNorm statistics 1e-3 (sums
    over every position of the batch, in cuDNN's order on the card and
    oneDNN's on the CPU, the biases' gradient sums scaled by lr 0.1;
    through 75 conv layers).  The EMA as its parameters."""
    import copy

    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
    from adaptiveisp_tpu_torch.detect.loss import LossHyp
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.detect.train_detector import (
        DetTrainConfig,
        init_detector_train_state,
        make_detector_train_step,
    )
    from adaptiveisp_tpu_torch.detect.train_loop import make_warmup_optimizer

    root = Path(__file__).resolve().parent / "build" / "det_smoke"
    ds = DetectorDataset(str(root / "train" / "images"),
                         img_size=DET_CPU_SIZE, batch_size=DET_CPU_BATCH,
                         augment=False, nc=80)
    batches = [b for _, b in zip(range(DET_CPU_STEPS),
                                 ds.epoch_batches(shuffle=False))]
    base = api.load_detector(spec=YOLOV3_SPEC, seed=0, device="cpu").model
    tx, _ = make_warmup_optimizer(DetTrainConfig(), 100)
    step = make_detector_train_step(anchors_in_grid_units(YOLOV3_SPEC),
                                    LossHyp(obj=(DET_CPU_SIZE / 640) ** 2))
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state = init_detector_train_state(copy.deepcopy(base).to(dev), tx)
        losses = []
        for b in batches:
            state, o = step(state, *(torch.from_numpy(a).to(dev) for a in b))
            losses.append(float(o["loss"]))
        out[dev] = {"losses": losses, "secs": time.perf_counter() - t0,
                    "model": {k: v.cpu() for k, v in
                              state.model.state_dict().items()},
                    "ema": {k: v.cpu() for k, v in state.ema.params.items()}}
    start = base.state_dict()
    worst, moved, fails = {}, {}, []
    for part in ("model", "ema"):
        for k, want in out["cpu"][part].items():
            if "num_batches" in k:
                continue
            got = out["cuda"][part][k]
            scale = float(want.abs().max()) or 1.0
            err = float((got - want).abs().max()) / scale
            tol = (1e-3 if k.endswith(("bias", "running_mean",
                                       "running_var")) else 1e-5)
            kind = "bias_stats" if tol == 1e-3 else "kernels"
            worst[f"{part}_{kind}"] = max(worst.get(f"{part}_{kind}", 0),
                                          err)
            if part == "model":
                mv = float((want - start[k]).abs().max()) / scale
                moved[kind] = max(moved.get(kind, 0.0), mv)
            if err > tol:
                fails.append((part, k, err))
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(out["cuda"]["losses"], out["cpu"]["losses"]))
    rec = {"phase": "detector_vs_cpu", "imgsz": DET_CPU_SIZE,
           "batch": DET_CPU_BATCH, "steps": DET_CPU_STEPS,
           "losses_cuda": out["cuda"]["losses"],
           "losses_cpu": out["cpu"]["losses"], "loss_rel_err": loss_err,
           "max_rel_err": worst, "moved_rel": moved,
           "cuda_s": out["cuda"]["secs"], "cpu_s": out["cpu"]["secs"],
           "fails": fails[:10]}
    emit(rec)
    if fails or loss_err > 1e-4:
        raise AssertionError(f"detector_vs_cpu: {rec}")
    return rec


def phase_detector_cli():
    """``train_loop.main`` at full width on the card: ``--spec yolov3
    --imgsz 640 --batch-size -1 --epochs 1`` on the detector data
    (autobatch sizes the batch from trial steps), then the written best.pt
    as ``val_isp --weights`` on 4 validation images."""
    import contextlib

    import torch
    import yaml

    from adaptiveisp_tpu_torch import val_isp
    from adaptiveisp_tpu_torch.detect import autobatch
    from adaptiveisp_tpu_torch.detect import train_loop

    root = Path(__file__).resolve().parent / "build" / "det_smoke"
    save = root / "cli"
    chosen = []
    fit = autobatch.fit_batch

    def record(*a, **k):
        chosen.append(fit(*a, **k))
        return chosen[-1]

    autobatch.fit_batch = record
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            hist = train_loop.main([
                "--data", str(root / "train" / "images"),
                "--val-data", str(root / "train" / "images"),
                "--spec", "yolov3", "--imgsz", str(DET_SIZE),
                "--batch-size", "-1", "--epochs", "1",
                "--save-dir", str(save), "--exist-ok", "--device", "cuda"])
    finally:
        autobatch.fit_batch = fit
    train_s = time.perf_counter() - t0
    opt = yaml.safe_load((save / "opt.yaml").read_text())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = val_isp.main([
            "--data", str(root / "val.yaml"), "--weights",
            str(save / "best.pt"), "--imgsz", "512", "--device", "cuda",
            "--max_images", "4", "--project", str(root / "val_cli"),
            "--name", "exp"])
    torch.cuda.synchronize()
    rec = {"phase": "detector_cli", "autobatch": chosen,
           "batch_size": opt["batch_size"], "train_s": train_s,
           "losses": [h.loss for h in hist], "val_isp_s":
           time.perf_counter() - t0, "val_isp_map50": res["map50"],
           "files": sorted(p.name for p in save.iterdir())}
    emit(rec)
    if (len(chosen) != 1 or opt["batch_size"] != chosen[0]
            or not (save / "best.pt").exists()
            or not np.isfinite(hist[0].loss)
            or not np.isfinite(res["map50"])):
        raise AssertionError(f"detector_cli: {rec}")
    return rec


# the inference surface: the hub's models at 640 px, the REST server and
# the detect CLI at the service size with an agent that picks denoise at
# every step (the seeded Config() agent, seed 0, with denoise's selector
# bias fc2.bias raised by DENOISE_BOOST), RAW synthesis at batch 8 @ 512
HUB_SIZE = 640
HUB_MODELS = ("yolov3", "yolov3_spp", "yolov5s")
HUB_ATOL = {"box_px": 0.05, "conf": 1e-4}
DENOISE_BOOST = 8.0
REST_SIZES = ((512, 512), (384, 640), (480, 360), (300, 500), (720, 540),
              (256, 256), (341, 600), (600, 400))   # (h, w) of the 8 PNGs
CLI_IMAGES, CLI_CPU_IMAGES = 8, 2
RAW_SHAPE = (8, 512, 512, 3)


def _decoded_err(det_g, det_c, x):
    """max |card - CPU| of two detectors' decoded candidates on x (boxes
    in pixels, then objectness and class scores)."""
    import torch

    with torch.no_grad():
        g = det_g.decoded(x.cuda()).cpu()
        c = det_c.decoded(x)
    return {"box_px": float((g[..., :4] - c[..., :4]).abs().max()),
            "conf": float((g[..., 4:] - c[..., 4:]).abs().max()),
            "candidates": int(g.shape[1])}


def _rows_err(got, want, max_det: int = 300):
    """Detection rows [n, 6] of the card against the CPU's, as multisets:
    the counts equal, the sorted scores within HUB_ATOL, and each card row
    matched to a CPU row of its class within HUB_ATOL (box error the
    largest over the matches).  Scores of random detectors cluster
    (within 1e-6 of each other), so rows of nearly equal score come in
    either order, and when ``max_det`` rows are kept, which of the
    candidates within 1e-4 of the lowest kept score make the cut is a
    tie-break: those rows are not matched (``at_cut``).  None when the
    counts differ."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return None
    if not len(got):
        return {"box_px": 0.0, "conf": 0.0, "unmatched": 0, "at_cut": 0}
    cut = (min(got[:, 4].min(), want[:, 4].min()) + HUB_ATOL["conf"]
           if len(got) >= max_det else -np.inf)
    used = np.zeros(len(want), bool)
    box, unmatched = 0.0, 0
    for r in got[got[:, 4] > cut]:
        cand = np.flatnonzero(~used & (want[:, 5] == r[5]) & (np.abs(
            want[:, 4] - r[4]) <= HUB_ATOL["conf"]))
        d = (np.abs(want[cand, :4] - r[:4]).max(1) if len(cand)
             else np.zeros(0))
        if len(d) and d.min() <= HUB_ATOL["box_px"]:
            used[cand[d.argmin()]] = True
            box = max(box, float(d.min()))
        else:
            unmatched += 1
    return {"box_px": box, "conf": float(np.abs(
        np.sort(got[:, 4]) - np.sort(want[:, 4])).max()),
        "unmatched": unmatched, "at_cut": int((got[:, 4] <= cut).sum())}


def _within(err):
    return (err is not None and all(err[k] <= HUB_ATOL[k] for k in HUB_ATOL)
            and not err.get("unmatched"))


def phase_hub():
    """The hub constructors on the card at full width and 640 px
    (``api.yolov3()``, ``api.yolov3_spp()``, ``api.yolov5s()``), each with
    ``spread_detector_state`` weights (a fresh detector's head scores all
    sit near 0.25, so NMS would keep boxes by float32 tie-breaks): each
    forward's decoded predictions against the same state_dict on the CPU
    (float32 sums in another order through up to 75 layers: boxes within
    0.05 px of a 640 px frame, scores within 1e-4); ``Detector.__call__``
    on a path, a PIL image and a uint8 array against the CPU's (rows as
    multisets, ``_rows_err``); an NMS
    ensemble of two YOLOv3 weight files written under ``build/hub_smoke``
    against the CPU's.  Returns the first weight file's path."""
    import torch
    from PIL import Image

    from adaptiveisp_tpu_torch import api

    root = Path(__file__).resolve().parent / "build" / "hub_smoke"
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.rand(1, HUB_SIZE, HUB_SIZE, 3).astype(
        np.float32))
    models, dets = {}, {}
    for i, name in enumerate(HUB_MODELS):
        det = getattr(api, name)(device="cuda")
        sd = spread_detector_state(det.spec, 7 + i)
        det.model.load_state_dict(sd)
        cpu = api.load_detector(spec=det.spec, device="cpu", state_dict=sd)
        xg = x.cuda()
        with torch.no_grad():
            ms = cuda_time_ms(lambda: det.decoded(xg), REPS)
        err = _decoded_err(det, cpu, x)
        models[name] = {"params": sum(p.numel()
                                      for p in det.model.parameters()),
                        "forward_ms": ms, **err, "ok": _within(err)}
        dets[name] = (det, cpu, sd)
    det, cpu, sd0 = dets["yolov3"]
    path = root / "hub.png"
    Image.fromarray(rng.randint(0, 256, (480, 640, 3), np.uint8)).save(path)
    sources = [str(path),
               Image.fromarray(rng.randint(0, 256, (360, 500, 3), np.uint8)),
               rng.randint(0, 256, (400, 300, 3), np.uint8)]
    res_g, res_c = det(sources, size=HUB_SIZE), cpu(sources, size=HUB_SIZE)
    call_errs = [_rows_err(g, c) for g, c in zip(res_g.xyxy, res_c.xyxy)]
    weights = [root / "yolov3_spread7.pt", root / "yolov3_spread10.pt"]
    for w, sd in zip(weights, (sd0, spread_detector_state(det.spec, 10))):
        torch.save({"model": sd}, w)
    ens = api.load_detector(weights=[str(w) for w in weights],
                            device="cuda")
    ens_c = api.load_detector(weights=[str(w) for w in weights],
                              device="cpu")
    ens_err = _decoded_err(ens, ens_c, x)
    rec = {"phase": "hub", "size": HUB_SIZE, "models": models,
           "call_detections": [len(d) for d in res_g.xyxy],
           "call_errs": call_errs, "ensemble": ens_err,
           "ensemble_members": len(ens.model), "atol": HUB_ATOL}
    emit(rec)
    ok = (all(m["ok"] for m in models.values())
          and all(_within(e) for e in call_errs) and len(res_g) == 3
          and all(len(d) for d in res_g.xyxy)
          and _within(ens_err) and ens_err["candidates"]
          == 2 * models["yolov3"]["candidates"])
    if not ok:
        raise AssertionError(f"hub: {rec}")
    return weights[0]


def _denoise_agent(cfg):
    """The seeded Config() agent (seed 0) with denoise's selector bias
    raised by DENOISE_BOOST: argmax picks denoise at every step."""
    from adaptiveisp_tpu_torch import api

    sd = api.load_adaptive_isp(cfg=cfg, seed=0, device="cpu").agent \
        .state_dict()
    sd["fc2.bias"] = sd["fc2.bias"].clone()
    sd["fc2.bias"][cfg.filters.index("denoise")] += DENOISE_BOOST
    return sd


def _png_bytes(rng, h, w):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def phase_rest(weights):
    """``serve.rest`` on port 0 on the card: full YOLOv3 (the hub phase's
    ``spread_detector_state`` weights file), the
    denoising agent from a weights file at the service size (512), so each
    request letterboxes, runs the 5-step rollout (K1 at each step) and
    detects.  One warm-up request, then 8 POSTs of PNGs of different sizes
    (launch counts read around them), one /healthz and one body that is
    not an image (400).  Every answer equals the in-process
    ``rest.infer`` with the same detector and agent on the card; the
    latency median and p90 per request; one in-process request under the
    profiler (device kernel time, K1's share, launches; its wall time
    carries the profiler's own start-up)."""
    import contextlib
    import io
    import urllib.error
    import urllib.request

    import torch
    from PIL import Image
    from torch.profiler import ProfilerActivity, profile

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.serve import rest

    root = Path(__file__).resolve().parent / "build" / "rest_smoke"
    root.mkdir(parents=True, exist_ok=True)
    cfg = Config()
    agent = root / "agent.pt"
    torch.save({"agent_model": _denoise_agent(cfg)}, agent)
    rng = np.random.RandomState(12)
    bodies = [_png_bytes(rng, h, w) for h, w in REST_SIZES]

    def post(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{rest.ROUTE}", data=body,
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with contextlib.redirect_stdout(sys.stderr):
        srv = rest.serve(weights=str(weights), spec=YOLOV3_SPEC, port=0,
                         size=SERVE_SIZE, isp_weights=str(agent),
                         device="cuda")
    try:
        warm = post(srv.port, bodies[0])
        torch.cuda.synchronize()
        build.reset_launches()
        answers, lat = [], []
        for body in bodies:
            t0 = time.perf_counter()
            answers.append(post(srv.port, body))
            lat.append((time.perf_counter() - t0) * 1e3)
        launches = dict(build.LAUNCHES)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        bad = post(srv.port, b"not an image")
    finally:
        srv.stop()
    # the same requests in process, in the same order (the agent's noise
    # stream advances per request)
    det = api.load_detector(weights=str(weights), spec=YOLOV3_SPEC,
                            device="cuda")
    isp = api.load_adaptive_isp(str(agent), cfg=cfg, device="cuda")

    def image(body):
        return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"),
                          np.float32) / 255.0

    want = [rest.infer(det, image(b), SERVE_SIZE, 0.25, isp)
            for b in bodies[:1] + bodies]
    equal = ([warm[1]] + [a[1] for a in answers]) == want
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rest.infer(det, image(bodies[0]), SERVE_SIZE, 0.25, isp)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    device_ms = sum(k[0] for k in kernels) / 1e3
    nlm_ms = sum(k[0] for k in kernels if "nlm" in k[1].lower()) / 1e3
    codes = [warm[0]] + [a[0] for a in answers]
    rec = {"phase": "rest", "size": SERVE_SIZE, "requests": len(bodies),
           "image_hw": [list(s) for s in REST_SIZES], "codes": codes,
           "detections": [len(a[1]) for a in answers],
           "latency_ms": lat, "latency_ms_median": float(np.median(lat)),
           "latency_ms_p90": float(np.percentile(lat, 90)),
           "launches": launches, "healthz": health, "bad_body": bad[0],
           "equal_in_process": equal,
           "profiled_request": {
               "wall_ms": wall_ms, "device_kernel_ms": device_ms,
               "nlm_kernel_ms": nlm_ms,
               "kernel_launches": sum(k[2] for k in kernels),
               "device_share_of_median_latency":
                   device_ms / float(np.median(lat)),
               "top_kernels": [{"name": k[1][:90], "ms": k[0] / 1e3,
                                "count": k[2]} for k in kernels[:8]]},
           "agent": f"seeded Config() agent, fc2.bias[denoise] "
                    f"+{DENOISE_BOOST}"}
    emit(rec)
    if (any(c != 200 for c in codes) or bad[0] != 400
            or health != {"status": "ok"} or not equal
            or launches["nlm_gray_fwd"] != STEPS * len(bodies)):
        raise AssertionError(f"rest: {rec}")
    return launches, agent


def _cli_labels(d):
    return {p.name: np.loadtxt(p, ndmin=2) for p in sorted(d.glob("*.txt"))}


def phase_detect_cli(weights, agent):
    """``detect_cli.main`` (``python -m adaptiveisp_tpu_torch.detect_cli``,
    in process so that its launches are counted) with ``--device cuda
    --isp_weights`` (the rest phase's denoising agent) ``--save_txt
    --save_img`` on 8 PNGs of different sizes at 512 px, the hub phase's
    YOLOv3 file as ``--weights``; then ``--device cpu`` on the
    first 2 of them (its NLM at 512 px is seconds a call on the host): the
    same label files, rows within the hub phase's tolerances as multisets
    (``_rows_err``).  The frame
    loop is timed apart from the set-up (weights, agent, cuDNN plans)."""
    import contextlib
    import shutil

    import torch
    from PIL import Image

    from adaptiveisp_tpu_torch import detect_cli
    from adaptiveisp_tpu_torch.ops.cuda import build

    root = Path(__file__).resolve().parent / "build" / "cli_smoke"
    shutil.rmtree(root, ignore_errors=True)
    images, cpu_images = root / "images", root / "images_cpu"
    images.mkdir(parents=True)
    cpu_images.mkdir()
    rng = np.random.RandomState(13)
    for i, (h, w) in enumerate(REST_SIZES[:CLI_IMAGES]):
        im = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
        im.save(images / f"frame{i}.png")
        if i < CLI_CPU_IMAGES:
            im.save(cpu_images / f"frame{i}.png")
    base = ["--weights", str(weights), "--isp_weights", str(agent),
            "--imgsz", str(SERVE_SIZE), "--save_txt", "--save_img",
            "--exist_ok"]
    frames_s = []
    run_source = detect_cli._run_source

    def timed_frames(*a, **k):  # the frame loop, without the set-up
        t = time.perf_counter()
        run_source(*a, **k)
        torch.cuda.synchronize()
        frames_s.append(time.perf_counter() - t)

    detect_cli._run_source = timed_frames
    build.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            out = detect_cli.main(["--source", str(images), "--device",
                                   "cuda", "--save_dir", str(root / "cuda")]
                                  + base)
    finally:
        detect_cli._run_source = run_source
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        out_c = detect_cli.main(["--source", str(cpu_images), "--device",
                                 "cpu", "--save_dir", str(root / "cpu")]
                                + base)
    cpu_secs = time.perf_counter() - t0
    got, want = _cli_labels(Path(out)), _cli_labels(Path(out_c))
    errs = {k: _rows_err(got.get(k, np.zeros((0, 6))), v)
            for k, v in want.items()}
    pngs = sorted(p.name for p in Path(out).glob("*.png"))
    rec = {"phase": "detect_cli", "frames": CLI_IMAGES,
           "seconds": secs, "frames_seconds": sum(frames_s),
           "ms_per_frame": sum(frames_s) * 1e3 / CLI_IMAGES,
           "launches": launches, "labels": len(got), "images_saved":
           len(pngs), "detections": {k: len(v) for k, v in got.items()},
           "cpu_frames": CLI_CPU_IMAGES, "cpu_seconds": cpu_secs,
           "vs_cpu": errs, "atol": HUB_ATOL}
    emit(rec)
    if (len(got) != CLI_IMAGES or len(pngs) != CLI_IMAGES
            or len(want) != CLI_CPU_IMAGES
            or not all(_within(e) for e in errs.values())
            or launches["nlm_gray_fwd"] != STEPS * CLI_IMAGES):
        raise AssertionError(f"detect_cli: {rec}")
    return launches


def phase_raw_unprocess():
    """``raw.unprocess.unprocess_batch`` at [8,512,512,3] on the card (one
    draw per image from a CUDA generator, log noise, brightness in [0.1,
    0.3]), then again on the card and on the CPU with that metadata and
    noise field: within 1e-5 (transcendentals a few ulp apart, times
    gains up to about 3); the card's call timed."""
    import torch

    from adaptiveisp_tpu_torch.raw import unprocess as un

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(RAW_SHAPE, generator=g, device="cuda")
    noise = torch.randn(RAW_SHAPE, generator=g, device="cuda")
    kw = dict(add_noise=True, brightness_range=(0.1, 0.3))
    drawn, meta = un.unprocess_batch(x, generator=g, noise=noise, **kw)
    out, _ = un.unprocess_batch(x, meta=meta, noise=noise, **kw)
    ms = cuda_time_ms(lambda: un.unprocess_batch(x, meta=meta, noise=noise,
                                                 **kw), REPS)
    cpu, _ = un.unprocess_batch(
        x.cpu(), meta=un.RawMetadata(*(f.cpu() for f in meta)),
        noise=noise.cpu(), **kw)
    err = float((out.cpu() - cpu).abs().max())
    rec = {"phase": "raw_unprocess", "shape": list(RAW_SHAPE),
           "max_abs_err": err, "atol": 1e-5,
           "replay_vs_drawn": float((out - drawn).abs().max()),
           "call_ms": ms, "finite": bool(torch.isfinite(out).all()),
           "range": [float(out.min()), float(out.max())],
           "gains": {k: [float(v.min()), float(v.max())] for k, v in
                     (("red", meta.red_gain), ("blue", meta.blue_gain),
                      ("brightness", meta.gain))}}
    emit(rec)
    if not (err <= 1e-5 and rec["finite"] and rec["range"][0] >= 0.0
            and rec["range"][1] <= 1.0 and tuple(out.shape) == RAW_SHAPE):
        raise AssertionError(f"raw_unprocess: {rec}")


# segmentation and classification at full width: YOLOv3's widths with the
# Segment head (80 classes, nm 32, npr 256) at 640 px and batch 16, masks at
# a quarter of the input (the Proto tower's 160 x 160); the Darknet-53
# classifier at 224 px and batch 64.  None of these paths launches K1-K4.
SEG_BASE, SEG_IMAGES, SEG_VAL, SEG_SIZE, SEG_BATCH = "yolov3", 64, 16, 640, 16
SEG_NM, SEG_NPR = 32, 256
SEG_CPU_SIZE, SEG_CPU_BATCH, SEG_CPU_STEPS = 128, 2, 3
SEG_CLI_IMAGES, SEG_CLI_CPU_IMAGES = 8, 2
SEG_MASK_IOU = 0.98
CLS_BACKBONE, CLS_CLASSES, CLS_PER_CLASS, CLS_VAL_PER_CLASS = (
    "yolov3", 10, 64, 16)
CLS_SIZE, CLS_BATCH = 224, 64
CLS_CPU_SIZE, CLS_CPU_BATCH, CLS_CPU_STEPS = 64, 4, 3
CLS_OPTIMIZERS = ("SGD", "Adam", "AdamW", "RMSProp")
CARD = "cuda"   # the device of the card's side of each comparison


def _seg_spec():
    """The segmentation spec of SEG_BASE and its mask ratio (the Proto
    tower's output is the first level upsampled 2x: ratio 4 for YOLOv3)."""
    from adaptiveisp_tpu_torch.detect.model import model_strides
    from adaptiveisp_tpu_torch.detect.segment import seg_spec_from
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec

    spec = seg_spec_from(resolve_spec(SEG_BASE), nm=SEG_NM, npr=SEG_NPR)
    return spec, model_strides(spec)[0] // 2


def _seg_data():
    """SEG_IMAGES seeded synthetic polygon PNGs at SEG_SIZE, the last
    SEG_VAL of them for validation, 2-5 filled polygons (3-8 vertices) of
    the 80 classes each, with polygon labels, under build/seg_smoke."""
    import shutil

    from PIL import Image, ImageDraw

    root = Path(__file__).resolve().parent / "build" / "seg_smoke"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(81)
    s = SEG_SIZE
    for i in range(SEG_IMAGES):
        split = "val" if i >= SEG_IMAGES - SEG_VAL else "train"
        (root / split / "images").mkdir(parents=True, exist_ok=True)
        (root / split / "labels").mkdir(exist_ok=True)
        img = Image.fromarray((rng.rand(s, s, 3) * 0.25 * 255 + rng.rand(3)
                               * 0.4 * 255).astype(np.uint8))
        draw, rows = ImageDraw.Draw(img), []
        for _ in range(rng.randint(2, 6)):
            k = rng.randint(3, 9)
            cx, cy = rng.uniform(0.2, 0.8, 2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            rad = rng.uniform(0.05, 0.2, k)
            pts = np.clip(np.stack([cx + rad * np.cos(ang),
                                    cy + rad * np.sin(ang)], 1), 0.0, 1.0)
            draw.polygon([(float(x) * s, float(y) * s) for x, y in pts],
                         fill=tuple(int(v) for v in rng.randint(0, 256, 3)))
            rows.append(f"{rng.randint(0, 80)} "
                        + " ".join(f"{v:.6f}" for v in pts.ravel()) + "\n")
        img.save(root / split / "images" / f"{i}.png")
        (root / split / "labels" / f"{i}.txt").write_text("".join(rows))
    return root


def _launch_counts():
    from adaptiveisp_tpu_torch.ops.cuda import build

    return dict(build.LAUNCHES)


def phase_segment_train(smi):
    """Segmentation training at full width on the card:
    ``detect.segment.SegmentTrainer`` on YOLOv3's widths with the Segment
    head (80 classes, nm 32, npr 256), 640 px, batch 16, masks at 160 x
    160 (mask ratio 4), f32, flips and copy-paste, one epoch over the
    training images with box + mask validation on the last 16; each step
    timed by CUDA events, each batch's host data time by the host clock,
    the peak of device memory (the mask loss forms [16, 5, 3, 32, 160,
    160] per level)."""
    import contextlib

    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.segment_dataset import SegmentDataset
    from adaptiveisp_tpu_torch.detect.segment import SegmentTrainer
    from adaptiveisp_tpu_torch.detect.train_detector import DetTrainConfig
    from adaptiveisp_tpu_torch.ops.cuda import build

    root = _seg_data()
    spec, ratio = _seg_spec()
    kw = dict(img_size=SEG_SIZE, batch_size=SEG_BATCH, mask_ratio=ratio)
    tds = SegmentDataset(str(root / "train" / "images"), augment=True,
                         copy_paste=0.5, seed=0, **kw)
    vds = SegmentDataset(str(root / "val" / "images"), augment=False, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = api.load_detector(spec=spec, seed=0, device=CARD).model
    tr = SegmentTrainer(model, spec, tds, vds,
                        cfg=DetTrainConfig(epochs=1, batch_size=SEG_BATCH),
                        save_dir=str(root / "run"), nm=SEG_NM, device=CARD)
    events, data_ms, epoch_s, val_s = [], [], [], []
    step_fn = tr.step_fn

    def timed_step(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step_fn(*a)
        e1.record()
        events.append((e0, e1))
        return out

    def timed_host(fn, sink):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sink.append(time.perf_counter() - t0)
            return out
        return run

    tr.step_fn = timed_step
    tr.train_ds.collate = timed_host(tr.train_ds.collate, data_ms)
    tr.train_epoch = timed_host(tr.train_epoch, epoch_s)
    tr._validate = timed_host(tr._validate, val_s)
    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        hist = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    step_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    m = hist[0].metrics
    rec = {"phase": "segment_train", "nvidia_smi": smi,
           "spec": f"{SEG_BASE}-seg",
           "imgsz": SEG_SIZE, "batch": SEG_BATCH, "nm": SEG_NM,
           "npr": SEG_NPR, "proto": SEG_SIZE // ratio,
           "train_images": len(tds), "val_images": len(vds),
           "params": sum(p.numel() for p in tr.model.parameters()),
           "loss": hist[0].loss, "step_ms": step_ms,
           "step_ms_median_after_first": float(np.median(step_ms[1:])),
           "images_per_s": SEG_BATCH * 1e3 / float(np.median(step_ms[1:])),
           "host_data_ms_per_batch": [d * 1e3 for d in data_ms],
           "host_data_ms_median": float(np.median(data_ms)) * 1e3,
           "epoch_train_s": epoch_s[0],
           "busy_share": sum(step_ms) / 1e3 / epoch_s[0],
           "validation_s": val_s[0], "fit_s": fit_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "box_map50": m["box"]["map50"], "box_map": m["box"]["map"],
           "mask_map50": m["mask"]["map50"], "mask_map": m["mask"]["map"],
           "launches": launches,
           "files": sorted(p.name for p in (root / "run").iterdir())}
    emit(rec)
    if (not np.isfinite(hist[0].loss) or len(step_ms) != len(tds) // SEG_BATCH
            or any(launches.values())
            or not all(np.isfinite(rec[k]) for k in (
                "box_map50", "box_map", "mask_map50", "mask_map"))
            or "last.pt" not in rec["files"]):
        raise AssertionError(f"segment_train: {rec}")
    return rec


def _rel_tensor_errs(got, want, start, kernel_tol, stats_tol):
    """Per state_dict: the largest |card - CPU| over each tensor's largest
    value, kernels (conv and BatchNorm weights) and biases / statistics
    apart, with how far the CPU's moved from ``start`` on that scale, and
    the tensors beyond ``kernel_tol`` / ``stats_tol``."""
    worst, moved, fails = {}, {}, []
    for k, w in want.items():
        if "num_batches" in k:
            continue
        scale = float(w.abs().max()) or 1.0
        err = float((got[k] - w).abs().max()) / scale
        stat = k.endswith(("bias", "running_mean", "running_var"))
        kind = "bias_stats" if stat else "kernels"
        worst[kind] = max(worst.get(kind, 0.0), err)
        if start is not None:
            moved[kind] = max(moved.get(kind, 0.0),
                              float((w - start[k]).abs().max()) / scale)
        if err > (stats_tol if stat else kernel_tol):
            fails.append((k, err))
    return worst, moved, fails


def phase_segment_vs_cpu():
    """The full-width segmentation spec at batch 2 @ 128 px (masks 32 x
    32), augmentation off, three ``make_segment_train_step`` steps with
    the warmup optimizer on the card and on the CPU from one state (TF32
    off, cuDNN deterministic).  Tolerances as ``detector_vs_cpu`` states
    them: loss 1e-4 relative; conv kernels and BatchNorm weights 1e-5 of
    their largest value; biases and BatchNorm statistics 1e-3; the EMA as
    its parameters."""
    import copy

    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.segment_dataset import SegmentDataset
    from adaptiveisp_tpu_torch.detect.loss import LossHyp
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
    from adaptiveisp_tpu_torch.detect.segment import make_segment_train_step
    from adaptiveisp_tpu_torch.detect.train_detector import (
        DetTrainConfig,
        init_detector_train_state,
    )
    from adaptiveisp_tpu_torch.detect.train_loop import make_warmup_optimizer

    root = Path(__file__).resolve().parent / "build" / "seg_smoke"
    spec, ratio = _seg_spec()
    ds = SegmentDataset(str(root / "train" / "images"), img_size=SEG_CPU_SIZE,
                        batch_size=SEG_CPU_BATCH, mask_ratio=ratio)
    batches = [b for _, b in zip(range(SEG_CPU_STEPS),
                                 ds.epoch_batches(shuffle=False))]
    base = api.load_detector(spec=spec, seed=0, device="cpu").model
    tx, _ = make_warmup_optimizer(DetTrainConfig(), 100)
    step = make_segment_train_step(anchors_in_grid_units(spec),
                                   LossHyp(obj=(SEG_CPU_SIZE / 640) ** 2))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    try:
        for dev in (CARD, "cpu"):
            t0 = time.perf_counter()
            state = init_detector_train_state(copy.deepcopy(base).to(dev), tx)
            losses, segs = [], []
            for b in batches:
                state, o = step(state, *(torch.from_numpy(a).to(dev)
                                         for a in b))
                losses.append(float(o["loss"]))
                segs.append(float(o["components"]["seg"]))
            out[dev] = {"losses": losses, "seg": segs,
                        "secs": time.perf_counter() - t0,
                        "model": {k: v.cpu() for k, v in
                                  state.model.state_dict().items()},
                        "ema": {k: v.cpu() for k, v in
                                state.ema.params.items()}}
    finally:
        torch.backends.cudnn.deterministic = False
    start = base.state_dict()
    worst, moved, fails = _rel_tensor_errs(
        out[CARD]["model"], out["cpu"]["model"], start, 1e-5, 1e-3)
    ema_worst, _, ema_fails = _rel_tensor_errs(
        out[CARD]["ema"], out["cpu"]["ema"], None, 1e-5, 1e-3)
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(out[CARD]["losses"], out["cpu"]["losses"]))
    rec = {"phase": "segment_vs_cpu", "imgsz": SEG_CPU_SIZE,
           "batch": SEG_CPU_BATCH, "steps": SEG_CPU_STEPS,
           "losses_cuda": out[CARD]["losses"],
           "losses_cpu": out["cpu"]["losses"],
           "seg_loss_cuda": out[CARD]["seg"], "seg_loss_cpu": out["cpu"]["seg"],
           "loss_rel_err": loss_err, "max_rel_err": worst,
           "ema_max_rel_err": ema_worst, "moved_rel": moved,
           "cuda_s": out[CARD]["secs"], "cpu_s": out["cpu"]["secs"],
           "fails": (fails + ema_fails)[:10]}
    emit(rec)
    if fails or ema_fails or loss_err > 1e-4 or not all(
            s > 0 for s in out["cpu"]["seg"]):
        raise AssertionError(f"segment_vs_cpu: {rec}")
    return rec


def _seg_rows_err(got, want, max_det: int):
    """``_rows_err`` of a frame's card and CPU instances (the CLI's
    result dicts), with the mask IoU of each matched pair (the smallest)."""
    g, w = got["det"], want["det"]
    err = _rows_err(g, w, max_det=max_det)
    if err is None or not len(g):
        return err
    cut = (min(g[:, 4].min(), w[:, 4].min()) + HUB_ATOL["conf"]
           if len(g) >= max_det else -np.inf)
    used, ious = np.zeros(len(w), bool), []
    for i, r in enumerate(g):
        if r[4] <= cut:
            continue
        cand = np.flatnonzero(~used & (w[:, 5] == r[5]) & (np.abs(
            w[:, 4] - r[4]) <= HUB_ATOL["conf"]))
        if not len(cand):
            continue
        j = cand[np.abs(w[cand, :4] - r[:4]).max(1).argmin()]
        used[j] = True
        a, b = got["masks"][i] > 0.5, want["masks"][j] > 0.5
        union = (a | b).sum()   # two empty masks agree
        ious.append(float((a & b).sum() / union) if union else 1.0)
    err["mask_iou_min"] = min(ious) if ious else None
    err["mask_pairs"] = len(ious)
    return err


def phase_segment_cli():
    """The predict CLI (``detect.segment.main``) at full width on the card:
    ``--spec yolov3 --imgsz 640 --save_txt`` with ``spread_detector_state``
    weights of the segmentation spec (a fresh head's scores cluster), on 8
    of the training PNGs, run twice (the second run timed: ms per frame
    without the set-up, the model's build, weights and move, timed
    apart); then ``--device cpu`` on the first 2:
    boxes as multisets (``_rows_err``) and each matched instance's mask
    IoU at least SEG_MASK_IOU (bilinear masks thresholded at 0.5: pixels
    within float32 noise of the threshold may flip).  Then ``train`` for
    one epoch at 640 px and batch 16 (the spec's mask ratio, 4), and its
    last.pt through ``train --validate-only``."""
    import contextlib
    import shutil

    import torch

    from adaptiveisp_tpu_torch.detect import segment as seg

    from adaptiveisp_tpu_torch.ops.cuda import build

    root = Path(__file__).resolve().parent / "build" / "seg_smoke"
    spec, _ = _seg_spec()
    weights = root / "spread.pt"
    torch.save({"model": spread_detector_state(spec, 17)}, weights)
    src, src_cpu = root / "cli_images", root / "cli_images_cpu"
    for d in (src, src_cpu):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir()
    for i in range(SEG_CLI_IMAGES):
        shutil.copy(root / "train" / "images" / f"{i}.png", src / f"{i}.png")
        if i < SEG_CLI_CPU_IMAGES:
            shutil.copy(src / f"{i}.png", src_cpu / f"{i}.png")
    base = ["--spec", SEG_BASE, "--nm", str(SEG_NM), "--npr", str(SEG_NPR),
            "--imgsz", str(SEG_SIZE), "--weights", str(weights),
            "--save_txt"]
    secs, setup_s = [], []
    new_model = seg._new_model

    def timed_model(*a, **k):   # the set-up: build, weights, to the card
        t = time.perf_counter()
        out = new_model(*a, **k)
        setup_s.append(time.perf_counter() - t)
        return out

    seg._new_model = timed_model
    build.reset_launches()
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                res = seg.main(["--source", str(src), "--device", CARD,
                                "--save_dir", str(root / "cli_cuda")] + base)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    finally:
        seg._new_model = new_model
    launches = _launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res_c = seg.main(["--source", str(src_cpu), "--device", "cpu",
                          "--save_dir", str(root / "cli_cpu")] + base)
    cpu_s = time.perf_counter() - t0
    by_name = {r["name"]: r for r in res}
    errs = {r["name"]: _seg_rows_err(by_name[r["name"]], r, 100)
            for r in res_c}
    txts = sorted(p.name for p in (root / "cli_cuda").glob("*.txt"))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        hist = seg.train_main([
            "--data", str(root / "train" / "images"), "--val-data",
            str(root / "val" / "images"), "--spec", SEG_BASE,
            "--imgsz", str(SEG_SIZE), "--batch-size", str(SEG_BATCH),
            "--epochs", "1", "--save-dir", str(root / "cli_train"),
            "--exist-ok", "--device", CARD])
        val = seg.train_main([
            "--data", str(root / "val" / "images"), "--spec", SEG_BASE,
            "--imgsz", str(SEG_SIZE), "--batch-size", str(SEG_BATCH),
            "--validate-only", "--weights",
            str(root / "cli_train" / "last.pt"), "--device", CARD])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    rec = {"phase": "segment_cli", "frames": SEG_CLI_IMAGES,
           "seconds": secs, "setup_seconds": setup_s,
           "ms_per_frame": (secs[-1] - setup_s[-1]) * 1e3 / SEG_CLI_IMAGES,
           "instances": {r["name"]: len(r["det"]) for r in res},
           "txt_files": len(txts), "cpu_frames": SEG_CLI_CPU_IMAGES,
           "cpu_seconds": cpu_s, "vs_cpu": errs, "atol": HUB_ATOL,
           "mask_iou_floor": SEG_MASK_IOU, "launches": launches,
           "train_s": train_s, "train_loss": hist[0].loss,
           "validate_only": {p: val[p]["map50"] for p in ("box", "mask")}}
    emit(rec)
    ok = (len(res) == SEG_CLI_IMAGES and len(res_c) == SEG_CLI_CPU_IMAGES
          and sum(len(r["det"]) for r in res_c) > 0
          and all(_within(e) and (e["mask_iou_min"] is None
                                  or e["mask_iou_min"] >= SEG_MASK_IOU)
                  for e in errs.values())
          and sum(e["mask_pairs"] for e in errs.values() if e) > 0
          and len(txts) == sum(1 for r in res if len(r["det"]))
          and not any(launches.values()) and np.isfinite(hist[0].loss)
          and all(np.isfinite(v) for v in rec["validate_only"].values()))
    if not ok:
        raise AssertionError(f"segment_cli: {rec}")
    return rec


def _cls_data():
    """CLS_CLASSES seeded class folders under build/cls_smoke/{train,val}:
    each image noise over a class colour and a class stripe pattern, of
    varied sizes around 256 px (resized to the input on loading)."""
    import shutil

    from PIL import Image

    root = Path(__file__).resolve().parent / "build" / "cls_smoke"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(82)
    colours = rng.rand(CLS_CLASSES, 3)
    for split, n in (("train", CLS_PER_CLASS), ("val", CLS_VAL_PER_CLASS)):
        for c in range(CLS_CLASSES):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = rng.randint(200, 300, 2)
                im = rng.rand(h, w, 3) * 0.5 + colours[c] * 0.5
                im[::(c % 5) + 2] *= 0.6
                Image.fromarray((im * 255).astype(np.uint8)).save(
                    d / f"{i}.png")
    return root


def phase_classify_train(smi):
    """Classification at full width on the card: ``ClassifierTrainer``
    with ``ClassificationModel(spec=YOLOV3_SPEC)`` (the Darknet-53
    backbone and the 1280-wide head), 10 classes, 224 px, batch 64, SGD,
    one epoch over 640 seeded images with top-1 / top-5 on 160; each step
    timed by CUDA events, each batch's host load by the host clock; then
    the classify CLI (``classify.main``, its default YOLOv3-tiny backbone)
    for one epoch on the same folders and ``--validate-only`` on its
    best.pt."""
    import contextlib

    import torch

    from adaptiveisp_tpu_torch import classify as cls
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec
    from adaptiveisp_tpu_torch.ops.cuda import build

    root = _cls_data()
    tds = cls.FolderDataset(str(root / "train"), img_size=CLS_SIZE,
                            augment=True, seed=0)
    vds = cls.FolderDataset(str(root / "val"), img_size=CLS_SIZE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = cls.create_classifier(spec=resolve_spec(CLS_BACKBONE),
                                  nc=CLS_CLASSES, device=CARD)
    tr = cls.ClassifierTrainer(
        model, tds, vds, cfg=cls.ClsTrainConfig(epochs=1,
                                                batch_size=CLS_BATCH),
        save_dir=str(root / "run"), device=CARD)
    events, data_ms = [], []
    step_fn, batches = tr.step_fn, tds.epoch_batches

    def timed_step(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step_fn(*a)
        e1.record()
        events.append((e0, e1))
        return out

    def timed_batches(*a, **k):
        it = batches(*a, **k)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                return
            data_ms.append((time.perf_counter() - t0) * 1e3)
            yield b

    tr.step_fn, tds.epoch_batches = timed_step, timed_batches
    build.reset_launches()
    t0 = time.perf_counter()
    hist = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launch_counts()
    step_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    med = float(np.median(step_ms[1:]))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        cli_hist = cls.main(["--data", str(root), "--imgsz", str(CLS_SIZE),
                             "--batch-size", str(CLS_BATCH), "--epochs", "1",
                             "--save-dir", str(root / "cli"), "--exist-ok",
                             "--device", CARD])
        cli_val = cls.main(["--data", str(root), "--imgsz", str(CLS_SIZE),
                            "--batch-size", str(CLS_BATCH), "--validate-only",
                            "--weights", str(root / "cli" / "best.pt"),
                            "--device", CARD])
    torch.cuda.synchronize()
    rec = {"phase": "classify_train", "nvidia_smi": smi,
           "backbone": CLS_BACKBONE, "classes": CLS_CLASSES,
           "imgsz": CLS_SIZE, "batch": CLS_BATCH, "train_images": len(tds),
           "val_images": len(vds),
           "params": sum(p.numel() for p in model.parameters()),
           "loss": hist[0]["loss"], "top1": hist[0]["top1"],
           "top5": hist[0]["top5"], "step_ms": step_ms,
           "step_ms_median_after_first": med,
           "images_per_s": CLS_BATCH * 1e3 / med,
           "host_data_ms_per_batch": data_ms,
           "host_data_ms_median": float(np.median(data_ms)),
           "busy_share": sum(step_ms) / 1e3 / hist[0]["seconds"],
           "epoch_s": hist[0]["seconds"], "fit_s": fit_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "cli_s": time.perf_counter() - t0,
           "cli_loss": cli_hist[0]["loss"], "cli_top1": cli_hist[0]["top1"],
           "cli_validate_only": cli_val}
    emit(rec)
    if (not np.isfinite(hist[0]["loss"]) or len(step_ms) != len(tds)
            // CLS_BATCH or any(launches.values())
            or not 0 <= hist[0]["top1"] <= hist[0]["top5"] <= 1
            or not np.isfinite(cli_hist[0]["loss"])
            or not 0 <= cli_val["top1"] <= cli_val["top5"] <= 1):
        raise AssertionError(f"classify_train: {rec}")
    return rec


def _update_errs(got, want, lr_sum):
    """Card against CPU after steps of a normalising optimizer (Adam,
    AdamW, RMSProp): each element moves by about lr a step whatever its
    gradient's size, so an element whose gradient is within float32 noise
    of zero may move differently.  Over every parameter element: the
    largest difference over the summed lr, the share of elements more than
    1 % of the summed lr apart, and that share in the worst tensor."""
    worst, beyond, total, tensor_share = 0.0, 0, 0, 0.0
    for k, w in want.items():
        if "num_batches" in k or "running" in k:
            continue
        d = (got[k] - w).abs() / lr_sum
        worst = max(worst, float(d.max()))
        n = int((d > 0.01).sum())
        beyond, total = beyond + n, total + d.numel()
        tensor_share = max(tensor_share, n / d.numel())
    return worst, beyond / total, tensor_share


def phase_classify_vs_cpu(hub_weights):
    """The Darknet-53 classifier at batch 4 @ 64 px, three train steps per
    optimizer (SGD, Adam, AdamW, RMSProp) on the card and on the CPU from
    one state (TF32 off, cuDNN deterministic).  Tolerances: the losses 1e-4
    relative with SGD, 1e-3 with the normalising optimizers; SGD's
    parameters as ``detector_vs_cpu``'s (kernels 1e-5 of their largest
    value, biases and statistics 1e-3); the normalising optimizers'
    parameters within 2 summed lr of each other in every element and
    within 1 % of it in all but 1 % of all elements (``_update_errs``),
    their BatchNorm statistics 1e-2: a few elements of small gradient move
    differently and the statistics follow them (the first call measured
    0.68 summed lr at most, 1.6 % of a 64-element tensor beyond 1 % with
    Adam and 15.6 % with RMSProp, statistics 1.1e-3).  Then ``predict``
    (top 5, probabilities within 1e-4) and ``apply_classifier`` over the
    hub phase's YOLOv3 detections of 2 frames (the kept rows equal, each
    crop's class equal and its logits within 1e-3), the classifier on the
    card against the CPU."""
    import copy

    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch import classify as cls
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec

    rng = np.random.RandomState(83)
    base = cls.create_classifier(spec=resolve_spec(CLS_BACKBONE),
                                 nc=CLS_CLASSES, device="cpu")
    xs = [rng.rand(CLS_CPU_BATCH, CLS_CPU_SIZE, CLS_CPU_SIZE, 3).astype(
        np.float32) for _ in range(CLS_CPU_STEPS)]
    ys = [rng.randint(0, CLS_CLASSES, CLS_CPU_BATCH)
          for _ in range(CLS_CPU_STEPS)]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    per_opt, ok = {}, True
    try:
        for opt in CLS_OPTIMIZERS:
            cfg = cls.ClsTrainConfig(batch_size=CLS_CPU_BATCH, optimizer=opt)
            out = {}
            for dev in (CARD, "cpu"):
                model = copy.deepcopy(base).to(dev)
                st = cls.ClsTrainState(
                    model, cls.make_classifier_optimizer(cfg, 10)(model),
                    cls.ModelEMA(model, cfg.ema_decay))
                step = cls.make_classifier_train_step(cfg)
                losses = []
                for x, y in zip(xs, ys):
                    st, o = step(st, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).long().to(dev))
                    losses.append(float(o["loss"]))
                out[dev] = (losses, {k: v.detach().cpu() for k, v in
                                     model.state_dict().items()})
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(out[CARD][0], out["cpu"][0]))
            start = base.state_dict()
            if opt == "SGD":
                worst, moved, fails = _rel_tensor_errs(
                    out[CARD][1], out["cpu"][1], start, 1e-5, 1e-3)
                r = {"max_rel_err": worst, "moved_rel": moved,
                     "fails": fails[:5]}
                good = not fails
            else:
                lr_sum = sum(cls.cosine_decay_schedule(
                    cfg.lr0, 10, cfg.lrf)(t) for t in range(CLS_CPU_STEPS))
                worst, share, tensor_share = _update_errs(
                    out[CARD][1], out["cpu"][1], lr_sum)
                stats_worst, _, sfails = _rel_tensor_errs(
                    {k: v for k, v in out[CARD][1].items() if "running" in k},
                    {k: v for k, v in out["cpu"][1].items() if "running" in k},
                    None, 1e-2, 1e-2)
                r = {"max_err_over_lr_sum": worst,
                     "share_beyond_1pct_lr_sum": share,
                     "worst_tensor_share": tensor_share,
                     "stats_max_rel_err": stats_worst,
                     "stats_fails": sfails[:5]}
                good = worst <= 2.0 and share <= 1e-2 and not sfails
            r.update(losses_cuda=out[CARD][0], losses_cpu=out["cpu"][0],
                     loss_rel_err=loss_err)
            per_opt[opt] = r
            ok = ok and good and loss_err <= (1e-4 if opt == "SGD" else 1e-3)
    finally:
        torch.backends.cudnn.deterministic = False
    # predict and the second-stage gate on the hub detector's detections
    classes = [f"class{c}" for c in range(CLS_CLASSES)]
    card_m, cpu_m = copy.deepcopy(base).to(CARD).eval(), base.eval()
    frames = [rng.rand(480, 640, 3).astype(np.float32),
              rng.rand(360, 500, 3).astype(np.float32)]
    det = api.load_detector(weights=str(hub_weights), device=CARD)
    dets = [d for d in det(frames, size=HUB_SIZE).xyxy]
    crops = np.stack([f[:CLS_CPU_SIZE, :CLS_CPU_SIZE] for f in frames])
    p_card = cls.predict(card_m, crops, classes)
    p_cpu = cls.predict(cpu_m, crops, classes)
    pred_err = max(abs(a[1] - b[1]) for pa, pb in zip(p_card, p_cpu)
                   for a, b in zip(pa, pb))
    same_rank = all([c for c, _ in a] == [c for c, _ in b]
                    for a, b in zip(p_card, p_cpu))

    def gate(model, dev):
        logits = []

        def classify_fn(x):
            logits.append(model(torch.from_numpy(x).to(dev)).cpu())
            return logits[-1]

        with torch.no_grad():
            kept = cls.apply_classifier(dets, frames, classify_fn,
                                        imgsz=CLS_CPU_SIZE)
        return kept, torch.cat(logits)

    (kept_card, lg_card), (kept_cpu, lg_cpu) = (gate(card_m, CARD),
                                                gate(cpu_m, "cpu"))
    gate_equal = all(np.array_equal(a, b)
                     for a, b in zip(kept_card, kept_cpu))
    crop_argmax_equal = bool((lg_card.argmax(1) == lg_cpu.argmax(1)).all())
    crop_logit_err = float((lg_card - lg_cpu).abs().max())
    rec = {"phase": "classify_vs_cpu", "imgsz": CLS_CPU_SIZE,
           "batch": CLS_CPU_BATCH, "steps": CLS_CPU_STEPS,
           "optimizers": per_opt, "predict_max_prob_err": pred_err,
           "predict_same_ranks": same_rank,
           "detections": [len(d) for d in dets],
           "kept": [len(k) for k in kept_card], "gate_equal": gate_equal,
           "crops": int(lg_card.shape[0]),
           "crop_argmax_equal": crop_argmax_equal,
           "crop_logit_max_abs_err": crop_logit_err}
    emit(rec)
    if not (ok and pred_err <= 1e-4 and same_rank and gate_equal
            and crop_argmax_equal and crop_logit_err <= 1e-3
            and sum(len(d) for d in dets) > 0):
        raise AssertionError(f"classify_vs_cpu: {rec}")
    return rec


# --------------------------------------------------------------------------- #
# export, the Triton client, and the train step's device time by component
# --------------------------------------------------------------------------- #
EXPORT_SIZE, EXPORT_BATCH = 512, 1
EXPORT_ATOL = 1e-5      # the reloaded program against the eager run, card
TRITON_SIZE, TRITON_REQUESTS = 640, 8
TRACE_STEPS = 3
TRACE_OTHER_MAX = 0.15  # share of device time left outside every component


def _smoke_dir(name):
    root = Path(__file__).resolve().parent / "build" / name
    root.mkdir(parents=True, exist_ok=True)
    return root


def phase_export(smi):
    """``detect.export`` on the card at full width: the Config() agent
    biased to denoise (``_denoise_agent``) through ``export_adaptive_isp``
    at batch 1 @ 512, 5 steps; saved, loaded (``load_program``) and run,
    its launches read around the run (K1 once a step), against the eager
    rollout on the card (within EXPORT_ATOL); the same program moved to the
    CPU (``move_to_device_pass``) against the port's CPU rollout (the
    serving phase's card-against-CPU tolerance, 1e-4, selections equal);
    then full YOLOv3 (``spread_detector_state`` weights) through
    ``export_detector`` at 512 the same way (the CPU side at the hub
    phase's tolerances); then ``python -m adaptiveisp_tpu_torch.export_cli
    --include pt2 variables --validate`` once as a subprocess.  Returns
    the launch counts of the reloaded rollout's run."""
    import torch
    from torch.export.passes import move_to_device_pass

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.detect import export as ex
    from adaptiveisp_tpu_torch.detect.model import decode_predictions
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.eval.rollout import no_pipeline, rollout
    from adaptiveisp_tpu_torch.ops.cuda import build

    root = _smoke_dir("export_smoke")
    cfg = Config()
    sd = _denoise_agent(cfg)
    isp = api.load_adaptive_isp(None, cfg, EXPORT_SIZE, STEPS,
                                device="cuda", state_dict=sd)
    t0 = time.perf_counter()
    path = ex.export_adaptive_isp(cfg, isp.agent, str(root / "isp.pt2"),
                                  imgsz=EXPORT_SIZE, steps=STEPS,
                                  batch=EXPORT_BATCH)
    t1 = time.perf_counter()
    program = ex.load_program(path)
    t2 = time.perf_counter()
    nodes = [str(n.target) for gm in program.graph_module.modules()
             if isinstance(gm, torch.fx.GraphModule)
             for n in gm.graph.nodes if n.op == "call_function"]
    rng = np.random.RandomState(13)
    args = [torch.from_numpy(a) for a in (
        rng.rand(EXPORT_BATCH, EXPORT_SIZE, EXPORT_SIZE, 3).astype(
            np.float32),
        rng.randn(STEPS, EXPORT_BATCH, cfg.z_dim).astype(np.float32),
        np.zeros((EXPORT_BATCH, cfg.num_state_dim), np.float32))]
    args_g = [a.cuda() for a in args]
    run = program.module()
    with torch.no_grad():
        run(*args_g)   # warm-up: cuDNN plans
        torch.cuda.synchronize()
        build.reset_launches()
        got = run(*args_g)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        program_ms = cuda_time_ms(lambda: run(*args_g), REPS)
        eager_ms = cuda_time_ms(lambda: rollout(
            isp.agent, *args_g, no_pipeline(STEPS)), REPS)
    want = rollout(isp.agent, *args_g, no_pipeline(STEPS))
    err = {k: float((g.float() - w.float()).abs().max())
           for k, g, w in zip(("image", "states", "selected"), got,
                              (want.image, want.states, want.selected))}
    # the same program on the CPU against the port's CPU rollout
    cpu_prog = move_to_device_pass(program, "cpu").module()
    isp_c = api.load_adaptive_isp(None, cfg, EXPORT_SIZE, STEPS,
                                  device="cpu", state_dict=sd)
    with torch.no_grad():
        got_c = cpu_prog(*args)
    want_c = rollout(isp_c.agent, *args, no_pipeline(STEPS))
    err_cpu_prog = float((got_c[0] - want_c.image).abs().max())
    err_card_cpu = float((got[0].cpu() - got_c[0]).abs().max())
    sel_equal = bool(torch.equal(got[2].cpu(), got_c[2]))
    rollout_rec = {
        "size": EXPORT_SIZE, "batch": EXPORT_BATCH, "steps": STEPS,
        "export_s": t1 - t0, "load_s": t2 - t1,
        "pt2_bytes": os.path.getsize(path),
        "nlm_gray_nodes": nodes.count("adaptiveisp_tpu_torch.nlm_gray.default"),
        "graph_nodes": len(nodes), "launches": launches,
        "program_ms": program_ms, "eager_rollout_ms": eager_ms,
        "max_abs_err_vs_eager": err,
        "selected": got[2].flatten().tolist(),
        "cpu_program_vs_cpu_rollout": err_cpu_prog,
        "card_vs_cpu_program": err_card_cpu, "selected_equal": sel_equal}
    ok_roll = (launches == only(nlm_gray_fwd=STEPS)
               and rollout_rec["nlm_gray_nodes"] == STEPS
               and all(v <= EXPORT_ATOL for v in err.values())
               and err_cpu_prog <= 1e-6 and err_card_cpu <= 1e-4
               and sel_equal and bool(torch.isfinite(got[0]).all()))

    # full YOLOv3: forward + decode
    det_sd = spread_detector_state(YOLOV3_SPEC, 7)
    det = api.load_detector(spec=YOLOV3_SPEC, device="cuda",
                            state_dict=det_sd)
    t0 = time.perf_counter()
    dpath = ex.export_detector(det.model, str(root / "yolov3.pt2"),
                               imgsz=EXPORT_SIZE, spec=YOLOV3_SPEC)
    t1 = time.perf_counter()
    dprog = ex.load_program(dpath)
    x = torch.from_numpy(rng.rand(1, EXPORT_SIZE, EXPORT_SIZE, 3).astype(
        np.float32))
    with torch.no_grad():
        dgot = dprog.module()(x.cuda())
        dwant = decode_predictions(det.model(x.cuda()), YOLOV3_SPEC)
        dgot_c = move_to_device_pass(dprog, "cpu").module()(x)
    det_c = api.load_detector(spec=YOLOV3_SPEC, device="cpu",
                              state_dict=det_sd)
    dcpu = det_c.decoded(x)
    det_err = float((dgot - dwant).abs().max())
    det_cpu = {"box_px": float((dgot.cpu()[..., :4] - dcpu[..., :4])
                               .abs().max()),
               "conf": float((dgot.cpu()[..., 4:] - dcpu[..., 4:])
                             .abs().max()),
               "cpu_program_vs_cpu": float((dgot_c - dcpu).abs().max())}
    det_rec = {"size": EXPORT_SIZE, "export_s": t1 - t0,
               "pt2_bytes": os.path.getsize(dpath),
               "candidates": int(dgot.shape[1]),
               "max_abs_err_vs_eager": det_err, "vs_cpu": det_cpu,
               "atol_vs_cpu": HUB_ATOL}
    ok_det = (det_err <= EXPORT_ATOL and det_cpu["box_px"]
              <= HUB_ATOL["box_px"] and det_cpu["conf"] <= HUB_ATOL["conf"]
              and det_cpu["cpu_program_vs_cpu"] <= 1e-6)

    # the CLI, as a user runs it
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "adaptiveisp_tpu_torch.export_cli",
         "--include", "pt2", "variables", "--validate", "--out",
         str(root / "cli")], capture_output=True, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent)
    cli_s = time.perf_counter() - t0
    deltas = [float(t.split("=")[1]) for t in cli.stdout.split()
              if t.startswith("max|d|=")]
    cli_rec = {"rc": cli.returncode, "seconds": cli_s, "max_abs_d": deltas,
               "table": cli.stdout.strip().splitlines()[-3:]}
    ok_cli = (cli.returncode == 0 and len(deltas) == 1
              and deltas[0] <= EXPORT_ATOL)
    rec = {"phase": "export", "nvidia_smi": smi, "rollout": rollout_rec,
           "detector": det_rec, "cli": cli_rec, "atol": EXPORT_ATOL,
           "ok": ok_roll and ok_det and ok_cli}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"export: {rec} {cli.stderr[-2000:]}")
    return launches


def _kserve_handler(det, name, size):
    """A KServe-v2 HTTP handler over one detector on the card: metadata,
    the repository index, and ``infer`` with binary tensors (input
    ``images`` [1, size, size, 3] FP32, output ``decoded``)."""
    import http.server

    import torch

    n_out = None

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body, ctype="application/json", extra=None):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            meta = {"name": name, "platform": "pytorch_pt2",
                    "inputs": [{"name": "images", "datatype": "FP32",
                                "shape": [1, size, size, 3]}],
                    "outputs": [{"name": "decoded", "datatype": "FP32",
                                 "shape": [1, n_out, det.spec["nc"] + 5]}]}
            self._send(json.dumps(meta).encode())

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            if self.path == "/v2/repository/index":
                self._send(json.dumps([{"name": name}]).encode())
                return
            hlen = int(self.headers["Inference-Header-Content-Length"])
            (inp,) = json.loads(body[:hlen])["inputs"]
            x = np.frombuffer(body[hlen:hlen + inp["parameters"][
                "binary_data_size"]], np.float32).reshape(inp["shape"])
            with torch.no_grad():
                out = det.decoded(torch.from_numpy(x.copy()).to(det.device))
            blob = out.cpu().numpy().tobytes()
            hdr = json.dumps({"outputs": [
                {"name": "decoded", "datatype": "FP32",
                 "shape": list(out.shape),
                 "parameters": {"binary_data_size": len(blob)}}]}).encode()
            self._send(hdr + blob, "application/octet-stream",
                       {"Inference-Header-Content-Length": str(len(hdr))})

    with torch.no_grad():
        n_out = int(det.decoded(torch.zeros(
            (1, size, size, 3), device=det.device)).shape[1])
    return Handler


def phase_triton():
    """``serve.triton.TritonRemoteModel`` against an in-script KServe-v2
    server on a daemon thread, backed by the port's YOLOv3 ``Detector`` on
    the card (640 px, batch 1): the client's decoded output, a tensor on
    the card, equal bit for bit to the direct forward; median and p90 ms a
    request over TRITON_REQUESTS requests (one warm-up first)."""
    import http.server
    import threading

    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.serve.triton import TritonRemoteModel

    det = api.yolov3(device="cuda")
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), _kserve_handler(det, "yolov3", TRITON_SIZE))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        model = TritonRemoteModel(f"http://127.0.0.1:{httpd.server_port}")
        rng = np.random.RandomState(14)
        xs = [torch.from_numpy(rng.rand(1, TRITON_SIZE, TRITON_SIZE, 3)
                               .astype(np.float32)).cuda()
              for _ in range(TRITON_REQUESTS)]
        model(xs[0])   # warm-up
        lat, equal = [], []
        for x in xs:
            t0 = time.perf_counter()
            out = model(x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            with torch.no_grad():
                equal.append(bool(torch.equal(out, det.decoded(x))))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    rec = {"phase": "triton", "model": model.model_name,
           "runtime": model.runtime, "size": TRITON_SIZE,
           "requests": TRITON_REQUESTS, "output_device": str(out.device),
           "output_shape": list(out.shape), "bit_equal": equal,
           "latency_ms": lat, "latency_ms_median": float(np.median(lat)),
           "latency_ms_p90": float(np.percentile(lat, 90))}
    emit(rec)
    if not all(equal) or out.device != xs[0].device:
        raise AssertionError(f"triton: {rec}")


def phase_trace_breakdown(smi):
    """TRACE_STEPS bf16 train steps (Config(), TrainConfig(batch_size=8),
    full YOLOv3 reward detector, batch 8 @ 512) under
    ``obs.profile.trace``, after three untraced warm-up steps; the trace
    read back by ``obs.trace.trace_op_table`` and bucketed by
    ``component_breakdown`` into the step's ``record_function`` scopes
    (each holding forward plus backward): device ms per step, share,
    GFLOP (the profiler's counts: forward matrix products and
    convolutions, and the backward's matrix products) and achieved
    TFLOP/s per component; the step's FLOPs (``obs.roofline.cost_of``, one
    more step: forward and backward) and its MFU against
    ``device_peaks``.  Fails when more than TRACE_OTHER_MAX of the device
    time lands outside every component (the backward's attribution would
    have failed)."""
    import torch

    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.obs.profile import trace
    from adaptiveisp_tpu_torch.obs.roofline import (
        cost_of,
        device_peaks,
        utilization,
    )
    from adaptiveisp_tpu_torch.obs.trace import (
        component_breakdown,
        trace_op_table,
    )

    cfg, tcfg = Config(), TrainConfig(batch_size=SERVE_BATCH)
    state, step, batch = _train_setup(cfg, tcfg, SERVE_SIZE, SERVE_BATCH,
                                      torch.bfloat16, "cuda")
    gen = torch.Generator(device=batch[0].device)
    for i in range(3):
        gen.manual_seed(i)
        step(state, batch, gen, 0.0)
    torch.cuda.synchronize()
    log_dir = _smoke_dir("trace_smoke") / "train_step"
    t0 = time.perf_counter()
    with trace(str(log_dir)):
        for i in range(TRACE_STEPS):
            gen.manual_seed(3 + i)
            step(state, batch, gen, 0.0)
    traced_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    table = trace_op_table(str(log_dir))
    parse_s = time.perf_counter() - t0
    comps = component_breakdown(table)
    per_step = {k: {**v, "ms": v["ms"] / TRACE_STEPS,
                    "gflops": v["gflops"] / TRACE_STEPS}
                for k, v in comps.items()}
    gen.manual_seed(99)
    flops = cost_of(lambda: step(state, batch, gen, 0.0))["flops"]
    torch.cuda.synchronize()
    device_s = comps["total"]["ms"] / TRACE_STEPS / 1e3
    peaks = device_peaks()
    other = comps["other"]["pct"] / 100.0
    top_other = [{"name": r["name"][:80], "ms": r["duration_ps"] / 1e9,
                  "count": r["count"]} for r in table if not r["tf_op"]][:8]
    rec = {"phase": "trace_breakdown", "nvidia_smi": smi,
           "detector_dtype": "bf16", "batch": SERVE_BATCH,
           "size": SERVE_SIZE, "steps": TRACE_STEPS, "rows": len(table),
           "kernels": sum(r["count"] for r in table) / TRACE_STEPS,
           "components_per_step": per_step,
           "step_flops": flops, "peaks": peaks and vars(peaks),
           "utilization": utilization(device_s, flops),
           "other_share": other, "other_max": TRACE_OTHER_MAX,
           "top_other": top_other, "traced_s": traced_s,
           "parse_s": parse_s}
    emit(rec)
    if other > TRACE_OTHER_MAX or comps["total"]["ms"] <= 0:
        raise AssertionError(f"trace_breakdown: {other:.3f} of the device "
                             f"time outside every component")


# --------------------------------------------------------------------- #
# data parallelism: two gloo ranks on the one card (NCCL refuses two ranks
# on one device), each the same run as JAX's device r of make_mesh(2)
# --------------------------------------------------------------------- #
DP_RANKS, DP_STEPS = 2, 3
# the RL step's frozen detector: f32 and bf16 (the trainer's default),
# both held to JAX's sharded-step tolerances (tests/test_train_eval.py:
# value loss 1e-4, reward 1e-3 relative; the agent's loss as the reward)
DP_DTYPES = ("f32", "bf16")
DP_RTOL = {"value_loss": 1e-4, "reward": 1e-3, "agent_loss": 1e-3}
# Trainer(mesh=): the 128-slot pool (64 a rank), 3 iterations; at the RL
# path's full width (bf16 YOLOv3, global batch 8 @ 512, Config()) and at a
# size the ranks on the CPU repeat (YOLOv3-tiny f32, 4 @ 128, dropout off)
DP_TRAINER = dict(pool=128, iters=3)
DP_TRAINER_VS_CPU = dict(batch=4, size=128, dtype="float32",
                         cfg={"dropout_keep_prob": 1.0})
DP_LOSS_RTOL = 2e-4                  # JAX's sharded detector step
DP_PARAM_RTOL, DP_PARAM_ATOL = 2e-3, 2e-5


def _dp_dir():
    root = Path(__file__).resolve().parent / "build" / "dp_smoke"
    root.mkdir(parents=True, exist_ok=True)
    return root


def _digest(sd):
    """A hash of each tensor's bytes: the ranks' replicas compare bit for
    bit without writing both to disk."""
    import hashlib

    return {k: hashlib.sha1(v.detach().float().cpu().contiguous().numpy()
                            .tobytes()).hexdigest() for k, v in sd.items()}


def _cpu_sd(sd):
    return {k: v.detach().float().cpu().clone() for k, v in sd.items()}


def _dp_conf():
    """Everything the ranks need, so that a rank reads no module constant
    (a CPU rehearsal changes them in the parent only)."""
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC, resolve_spec

    seg_spec, seg_ratio = _seg_spec()
    root = _dp_dir()
    return {"device": CARD if CARD == "cpu" else "cuda:0", "root": str(root),
            "rl": dict(spec=YOLOV3_SPEC, size=SERVE_SIZE, batch=SERVE_BATCH,
                       dtypes=DP_DTYPES, steps=DP_STEPS),
            "trainer": dict(DP_TRAINER, data=str(_trainer_data_dir()),
                            spec=YOLOV3_SPEC, batch=SERVE_BATCH,
                            size=SERVE_SIZE, dtype="bfloat16", cfg={}),
            "trainer_vs_cpu": dict(DP_TRAINER, **DP_TRAINER_VS_CPU,
                                   data=str(_trainer_data_dir()),
                                   spec=resolve_spec("yolov3-tiny")),
            "val": dict(spec=YOLOV3_SPEC, size=SERVE_SIZE,
                        batch=SERVE_BATCH, protocol=VAL_PROTOCOL,
                        data=str(Path(__file__).resolve().parent / "build"
                                 / "val_smoke" / "data.yaml")),
            "det": dict(spec=YOLOV3_SPEC, size=DET_SIZE, batch=DET_BATCH,
                        data=str(Path(__file__).resolve().parent / "build"
                                 / "det_smoke" / "train" / "images"),
                        batch_file=str(root / "det_batch.pt")),
            "seg": dict(spec=seg_spec, ratio=seg_ratio, size=SEG_SIZE,
                        batch=SEG_BATCH, nm=SEG_NM,
                        data=str(Path(__file__).resolve().parent / "build"
                                 / "seg_smoke" / "train" / "images"),
                        batch_file=str(root / "seg_batch.pt")),
            "cls": dict(spec=resolve_spec(CLS_BACKBONE), nc=CLS_CLASSES,
                        size=CLS_SIZE, batch=CLS_BATCH,
                        data=str(Path(__file__).resolve().parent / "build"
                                 / "cls_smoke" / "train"),
                        batch_file=str(root / "cls_batch.pt"))}


def _trainer_data_dir():
    root = Path(__file__).resolve().parent / "build" / "train_smoke"
    return root if (root / "data.yaml").exists() else _trainer_data()


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def _timed_ms(fn, device):
    """(fn(), its ms: CUDA events on the card, the host clock else)."""
    import torch

    if str(device).startswith("cuda"):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def _dp_rl(c, device, mesh=None):
    """DP_STEPS train steps of the denoise-biased Config() agent (dropout
    on) with the frozen YOLOv3 (c["dtype"]) at the RL path's batch and
    size, from one seeded state and batch; over ``mesh`` each rank takes
    its rows.  detect_loss_weight 0.05 keeps the seeded detector's loss
    inside the reward's clip to [0, 1] (at the default 1.0 both losses
    clip to 1 and the detector reaches neither reward nor gradient)."""
    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.detect.loss import pad_targets
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib
    from adaptiveisp_tpu_torch.train.optim import make_optimizer
    from adaptiveisp_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )
    from adaptiveisp_tpu_torch.train.trainer import imgsz_hyp

    spec, size, n = c["spec"], c["size"], c["batch"]
    cfg = Config(detect_loss_weight=0.05)
    tcfg = TrainConfig(batch_size=n)
    agent = api.load_adaptive_isp(cfg=cfg, seed=0, device=device).agent
    agent.load_state_dict(_denoise_agent(cfg))
    value = api.load_value(cfg, seed=1, device=device)
    det = api.load_detector(spec=spec, seed=2, device=device,
                            dtype=torch.bfloat16 if c["dtype"] == "bf16"
                            else None).model
    for net in (agent, value, det):
        mesh_lib.replicate(mesh, net)
    tx = make_optimizer(tcfg.lr, tcfg.max_iter_step)
    state = init_train_state(agent, value, tx, tx)
    step = make_train_step(det, cfg, tcfg, anchors_in_grid_units(spec),
                           imgsz_hyp(size, spec["nc"], len(spec["anchors"])))
    rng = np.random.RandomState(120)
    labels = []
    for _ in range(n):
        k = rng.randint(2, 6)
        labels.append(np.concatenate(
            [rng.randint(0, spec["nc"], (k, 1)), rng.uniform(0.2, 0.8, (k, 2)),
             rng.uniform(0.05, 0.4, (k, 2))], 1))
    targets, tmask = pad_targets(labels, 64)
    batch = (rng.rand(n, size, size, 3).astype(np.float32),
             rng.rand(n, cfg.z_dim).astype(np.float32),
             np.zeros((n, cfg.num_state_dim), np.float32), targets, tmask)
    if mesh is not None:
        step = mesh_lib.shard_train_step(step, mesh)
        batch = mesh_lib.shard_batch(mesh, batch)
    else:
        batch = tuple(torch.from_numpy(a).to(device) for a in batch)
    gen = torch.Generator(device=device)
    _sync(device)
    build.reset_launches()
    metrics, ms = [], []
    for i in range(c["steps"]):
        gen.manual_seed(i)
        out, t = _timed_ms(lambda: step(state, batch, gen, i / 100.0), device)
        ms.append(t)
        metrics.append({k: float(out.metrics[k]) for k in
                        ("agent_loss", "value_loss", "reward", "penalty")})
        metrics[-1]["selected"] = out.metrics["selected_filter"].tolist()
    _sync(device)
    return {"launches": dict(build.LAUNCHES), "metrics": metrics, "ms": ms,
            "lr_sum": sum(tx.keywords["schedule"](i)
                          for i in range(c["steps"])),
            "agent": _cpu_sd(state.agent.state_dict()),
            "value": _cpu_sd(state.value.state_dict())}


def _dp_trainer(c, device, mesh):
    """``Trainer(mesh=)``: the Config() roster (with c["cfg"]'s changes),
    c["spec"] in c["dtype"] with cached rewards at global batch c["batch"]
    @ c["size"], the device pool of c["pool"] slots sharded over the
    ranks, c["iters"] iterations, then one forced refresh on each shard (a
    stopped trajectory, a kept write-back and a diverged batch) and one
    more iteration over the refreshed pool."""
    import torch

    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.policy.states import (
        STATE_STEP_DIM,
        STATE_STOPPED_DIM,
    )
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    data = check_dataset(str(Path(c["data"]) / "data.yaml"))
    cfg = Config(replay_memory_size=c["pool"], **c["cfg"])
    tcfg = TrainConfig(batch_size=c["batch"], imgsz=c["size"])
    tr = Trainer(cfg, tcfg, data["train"],
                 save_dir=str(Path(c["out"]) / f"exp{mesh.rank}"), log=False,
                 yolo_spec=c["spec"], yolo_dtype=c["dtype"],
                 device_replay=True, cached_reward=True,
                 data_source=data["source"], device=device, mesh=mesh)
    pool = tr.device_replay
    seen, sample = [], pool.sample

    def recorded(n):
        got = sample(n)
        seen.append((got[0].tolist(), got[2].tolist()))
        return got

    pool.sample = recorded
    iter_s = []
    try:
        _sync(device)
        build.reset_launches()
        t0 = time.perf_counter()
        tr.train(max_steps=c["iters"] - 1, print_freq=10 ** 9,
                 mark=lambda name: (_sync(device), iter_s.append(
                     (name, time.perf_counter())))
                 if name in ("start", "end") else None)
        _sync(device)
        launches = dict(build.LAUNCHES)
        seconds = time.perf_counter() - t0
        # the forced refresh: batch rows [2r, 2r + 2) live on shard r
        s = pool.shard_size
        idx = np.array([0, 5, s, s + 5])
        new_states = pool.states[idx].copy()
        new_states[[0, 2], STATE_STOPPED_DIM] = 1   # refreshed
        new_states[[1, 3], STATE_STEP_DIM] = 0      # written back
        own = torch.as_tensor(idx[pool._own_rows(4)] - pool.lo,
                              device=pool.images.device)
        losses = mesh_lib.all_gather(mesh, pool.loss_in.index_select(0, own))
        pool.replace(idx, pool.images.index_select(0, own) * 0.5, new_states,
                     retouch_loss=losses + 1.0)
        pool.replace(np.array([3, 6, s + 3, s + 6]), None, None,
                     diverged=True)
        tr.train(max_steps=c["iters"], print_freq=10 ** 9)
    finally:
        tr.close()
    starts = [t for n, t in iter_s if n == "start"]
    ends = [t for n, t in iter_s if n == "end"]
    return {"seen": seen, "history": tr.history,
            "states": pool.states.tolist(), "images": pool.images.cpu(),
            "loss_in": pool.loss_in.cpu(),
            "meta": [(os.path.basename(m["path"]), m["label"].tolist(),
                      m["shape"]) for m in pool.meta],
            "refreshes": pool.refreshes, "fresh_images": pool.fresh_images,
            "launches": launches, "seconds": seconds,
            "iter_ms": [(e - s) * 1e3 for s, e in zip(starts, ends)]}


def _dp_validation(c, device, mesh=None):
    """``run_validation`` at the reference protocol with the blend render
    at the RL batch: Config() agent (seed 0), YOLOv3 with
    ``spread_detector_state`` weights, the validation phase's labelled
    images."""
    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.data.datasets import ISPDataset
    from adaptiveisp_tpu_torch.eval.validator import run_validation
    from adaptiveisp_tpu_torch.ops.cuda import build

    cfg = Config()
    agent = api.load_adaptive_isp(cfg=cfg, seed=0, device=device).agent
    yolo = api.load_detector(spec=c["spec"], device=device,
                             state_dict=spread_detector_state(c["spec"],
                                                              7)).model
    ds = ISPDataset(check_dataset(c["data"])["val"], img_size=c["size"],
                    source="normalize", train=False)
    _sync(device)
    build.reset_launches()
    r, ms = _timed_ms(lambda: run_validation(
        cfg, agent.eval(), yolo.eval(), ds, **c["protocol"],
        batch_size=c["batch"], mesh=mesh), device)
    _sync(device)
    return {"records": r["records"], "map50": r["map50"], "map": r["map"],
            "ms": ms, "launches": dict(build.LAUNCHES)}


def _dp_detector_step(kind, c, device, mesh=None):
    """One step of the detector, segmentation or classifier trainer at its
    full width on the batch in c["batch_file"] (the ranks' rows of it over
    ``mesh``): (loss, model, EMA, ms)."""
    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch import classify as cls
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    batch = torch.load(c["batch_file"], weights_only=False)
    if kind == "cls":
        model = cls.create_classifier(spec=c["spec"], nc=c["nc"],
                                      device=device)
        tr = cls.ClassifierTrainer(
            model, cls.FolderDataset(c["data"], img_size=c["size"]),
            cfg=cls.ClsTrainConfig(epochs=1, batch_size=c["batch"]),
            device=device, mesh=mesh)
    else:
        from adaptiveisp_tpu_torch.detect.train_detector import DetTrainConfig

        model = api.load_detector(spec=c["spec"], seed=0,
                                  device=device).model
        cfg = DetTrainConfig(epochs=1, batch_size=c["batch"])
        if kind == "det":
            from adaptiveisp_tpu_torch.data.detector_dataset import (
                DetectorDataset,
            )
            from adaptiveisp_tpu_torch.detect.train_loop import (
                DetectorTrainer,
            )

            tds = DetectorDataset(c["data"], img_size=c["size"],
                                  batch_size=c["batch"], augment=False,
                                  nc=c["spec"]["nc"])
            tr = DetectorTrainer(model, c["spec"], tds, cfg=cfg,
                                 loggers=False, device=device, mesh=mesh)
        else:
            from adaptiveisp_tpu_torch.data.segment_dataset import (
                SegmentDataset,
            )
            from adaptiveisp_tpu_torch.detect.segment import SegmentTrainer

            tds = SegmentDataset(c["data"], img_size=c["size"],
                                 batch_size=c["batch"], augment=False,
                                 mask_ratio=c["ratio"])
            tr = SegmentTrainer(model, c["spec"], tds, cfg=cfg, nm=c["nm"],
                                loggers=False, device=device, mesh=mesh)
    arrays = tuple(batch)
    if mesh is not None:
        args = mesh_lib.shard_batch(mesh, arrays)
    else:
        args = tuple(torch.from_numpy(a).to(device) for a in arrays)
    if kind == "cls":
        args = (args[0], args[1].long())
    _sync(device)
    (state, out), ms = _timed_ms(lambda: tr.step_fn(tr.state, *args), device)
    return {"loss": float(out["loss"]), "ms": ms,
            "model": state.model.state_dict(), "ema": state.ema.params}


def dp_rank(root):
    """One rank of the data-parallel phases (started by ``phase_dp``):
    the RL step, the trainer, validation and the three detector trainers'
    first steps over a two-rank gloo mesh, each main run's launch counts
    read around it; writes rank<r>.pt under ``root``."""
    import torch

    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    conf = torch.load(os.path.join(root, "conf.pt"), weights_only=False)
    dev = conf["device"]
    mesh = mesh_lib.make_mesh(DP_RANKS, device=dev, backend="gloo")
    if dev.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // DP_RANKS))
    out = {**{f"rl_{d}": _dp_rl(dict(conf["rl"], dtype=d), mesh.device,
                                mesh) for d in conf["rl"]["dtypes"]},
           "trainer_vs_cpu": _dp_trainer(
               dict(conf["trainer_vs_cpu"], out=os.path.join(root, "small")),
               mesh.device, mesh)}
    full = _dp_trainer(dict(conf["trainer"], out=root), mesh.device, mesh)
    images = full.pop("images")   # the rank's shard: 64 slots @ 512
    full.update(images_finite=bool(torch.isfinite(images).all()),
                loss_in_finite=bool(torch.isfinite(full["loss_in"]).all()),
                shard_slots=int(images.shape[0]))
    del images
    out["trainer"] = full
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    out["val"] = _dp_validation(conf["val"], mesh.device, mesh)
    for kind in ("det", "seg", "cls"):
        r = _dp_detector_step(kind, conf[kind], mesh.device, mesh)
        keep = {"loss": r["loss"], "ms": r["ms"],
                "model_digest": _digest(r["model"])}
        if mesh.is_main:
            keep.update(model=_cpu_sd(r["model"]), ema=_cpu_sd(r["ema"]))
        out[kind] = keep
        del r
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
    torch.save(out, os.path.join(root, f"rank{mesh.rank}.pt"))


def dp_trainer_rank(root):
    """``_dp_trainer`` alone on a two-rank gloo mesh on the CPU: the card's
    run's reference."""
    import torch

    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    conf = torch.load(os.path.join(root, "conf.pt"), weights_only=False)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // DP_RANKS))
    mesh = mesh_lib.make_mesh(DP_RANKS, device="cpu")
    out = _dp_trainer(dict(conf["trainer_vs_cpu"],
                           out=os.path.join(root, "cpu")), "cpu", mesh)
    torch.save(out, os.path.join(root, f"cpu_rank{mesh.rank}.pt"))


def _dp_batches(conf):
    """The detector trainers' first batches (rows [r B/D, (r+1) B/D) are
    rank r's), saved for the ranks."""
    import torch

    from adaptiveisp_tpu_torch import classify as cls
    from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
    from adaptiveisp_tpu_torch.data.segment_dataset import SegmentDataset

    c = conf["det"]
    torch.save(list(next(DetectorDataset(
        c["data"], img_size=c["size"], batch_size=c["batch"], augment=False,
        nc=c["spec"]["nc"]).epoch_batches(shuffle=False))), c["batch_file"])
    c = conf["seg"]
    torch.save(list(next(SegmentDataset(
        c["data"], img_size=c["size"], batch_size=c["batch"], augment=False,
        mask_ratio=c["ratio"]).epoch_batches(shuffle=False))),
        c["batch_file"])
    c = conf["cls"]
    torch.save(list(next(cls.FolderDataset(c["data"], img_size=c["size"])
                         .epoch_batches(c["batch"], shuffle=False))),
               c["batch_file"])


def _dp_cli(data_yaml):
    """``train_isp --dp 1`` (NCCL, world size 1) against ``--dp 0``: 3
    iterations (0..2) at the RL batch and size each, cuDNN deterministic;
    (the runs: each one's live checkpoint payload, history, launches and
    ms an iteration (the DP machinery's own cost at one rank); the paths
    where the payloads differ bit for bit)."""
    import contextlib

    import torch
    import torch.distributed as dist

    from adaptiveisp_tpu_torch import train_isp
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train import checkpoint as ckpt_lib
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    runs, cwd = {}, os.getcwd()
    base = ["--task", "train", "--data_cfg", str(data_yaml),
            "--batch_size", str(SERVE_BATCH), "--imgsz", str(SERVE_SIZE),
            "--max_steps", "2", "--device", CARD,
            "--weights", "no_detector_weights.pt"]
    train = Trainer.train
    try:
        for dp in (0, 1):
            marks = []

            def timed(self, *a, **k):
                def mark(name):
                    if name in ("start", "end"):
                        _sync(CARD)
                        marks.append((name, time.perf_counter()))
                return train(self, *a, **k, mark=mark)

            Trainer.train = timed
            build.reset_launches()
            os.chdir(_dp_dir())
            try:
                with contextlib.redirect_stderr(sys.stdout):
                    tr = train_isp.main(base + ["--dp", str(dp),
                                                "--save_path", f"dp{dp}"])
            finally:
                os.chdir(cwd)
            _sync(CARD)
            starts = [t for n, t in marks if n == "start"]
            ends = [t for n, t in marks if n == "end"]
            runs[dp] = {"payload": ckpt_lib.payload(tr.state),
                        "history": tr.history,
                        "launches": dict(build.LAUNCHES),
                        "mesh": None if tr.mesh is None else
                        [tr.mesh.size, tr.mesh.backend],
                        "iter_ms": [(e - s) * 1e3
                                    for s, e in zip(starts, ends)]}
    finally:
        Trainer.train = train
        if dist.is_initialized():
            dist.destroy_process_group()
    return runs, _payload_diffs(runs[1]["payload"], runs[0]["payload"])


def _close_models(got, want):
    """Every tensor of ``got`` within (DP_PARAM_RTOL, DP_PARAM_ATOL) of
    ``want`` (JAX's sharded detector test): the worst excess and its key."""
    worst, where = 0.0, None
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].double(), w.detach().double().cpu()
        excess = float(((g - w).abs() - DP_PARAM_RTOL * w.abs()).max())
        if excess > worst:
            worst, where = excess, k
    return worst, where


def phase_dp(smi):
    """The data-parallel phases (module docstring, phase 29): the
    single-process references on the card, then one launch of two gloo
    ranks on the card (``dp_rank``), one on the CPU (``dp_trainer_rank``),
    then ``train_isp --dp 1`` against ``--dp 0``.  Returns each main run's
    launch counts by rank."""
    import gc

    import torch

    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    conf = _dp_conf()
    root = Path(conf["root"])
    torch.save(conf, root / "conf.pt")
    _dp_batches(conf)
    t0 = time.perf_counter()
    ref = {**{f"rl_{d}": _dp_rl(dict(conf["rl"], dtype=d), CARD)
              for d in conf["rl"]["dtypes"]},
           "val": _dp_validation(conf["val"], CARD)}
    for kind in ("det", "seg", "cls"):
        r = _dp_detector_step(kind, conf[kind], CARD)
        ref[kind] = {"loss": r["loss"], "ms": r["ms"],
                     "model": _cpu_sd(r["model"]), "ema": _cpu_sd(r["ema"])}
        del r
    gc.collect()
    if CARD != "cpu":
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_lib.launch("chip_smoke:dp_rank", DP_RANKS, str(root),
                    device=conf["device"], backend="gloo").wait()
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(DP_RANKS)]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_lib.launch("chip_smoke:dp_trainer_rank", DP_RANKS, str(root),
                    device="cpu").wait()
    cpu_ranks = [torch.load(root / f"cpu_rank{r}.pt", weights_only=False)
                 for r in range(DP_RANKS)]
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli, cli_diffs = _dp_cli(Path(conf["trainer"]["data"]) / "data.yaml")
    cli_s = time.perf_counter() - t0
    bad = []

    # ---- dp_train_step: each step against the single-process step ----
    for d in conf["rl"]["dtypes"]:
        key, tol = f"rl_{d}", DP_RTOL
        rl = {"steps": [], "launches": [r[key]["launches"] for r in ranks],
              "ms": [r[key]["ms"] for r in ranks],
              "single_ms": ref[key]["ms"]}
        for i, want in enumerate(ref[key]["metrics"]):
            got = ranks[0][key]["metrics"][i]
            rel = {k: abs(got[k] - want[k]) / (abs(want[k]) + 1e-5)
                   for k in tol}
            rl["steps"].append({"rel_err": rel, "selected_equal":
                                got["selected"] == want["selected"],
                                "single": {k: want[k] for k in tol}})
            if (any(rel[k] > tol[k] for k in tol)
                    or any(r[key]["metrics"][i] != got for r in ranks)):
                bad.append(f"dp_train_step {d} step {i}: {rel}")
        lr_sum = ref[key]["lr_sum"]
        rl["params"] = {net: _update_errs(ranks[0][key][net],
                                          ref[key][net], lr_sum)
                        for net in ("agent", "value")}
        rl["replicas_equal"] = all(
            torch.equal(ranks[0][key][net][k], ranks[1][key][net][k])
            for net in ("agent", "value") for k in ranks[0][key][net])
        for net, (worst, share, _) in rl["params"].items():
            if worst > 2.0 or share > 0.01:
                bad.append(f"dp_train_step {d} {net} parameters {worst} "
                           f"{share}")
        if not rl["replicas_equal"]:
            bad.append(f"dp_train_step {d} replicas differ")
        for r, lc in enumerate(rl["launches"]):
            if (lc["nlm_gray_fwd"] < DP_STEPS
                    or lc["nlm_gray_bwd"] < DP_STEPS):
                bad.append(f"dp_train_step {d} rank {r} launches {lc}")
        emit({"phase": "dp_train_step", "nvidia_smi": smi,
              "ranks": DP_RANKS, "backend": "gloo",
              "global_batch": conf["rl"]["batch"],
              "size": conf["rl"]["size"], "detector": f"yolov3 {d}", **rl,
              "tolerance": {**{f"{k}_rtol": v for k, v in tol.items()},
                            "params": "every element within 2 summed lr, "
                            "under 1 % beyond 1 % of it"}})

    # ---- dp_trainer: full width, the two ranks one run ----
    iters = DP_TRAINER["iters"]
    full = [r["trainer"] for r in ranks]
    finite = all(bool(np.isfinite([[h[k] for k in h] for h in f["history"]])
                      .all()) and f["images_finite"] and f["loss_in_finite"]
                 for f in full)
    same = {k: all(f[k] == full[0][k] for f in full)
            for k in ("history", "seen", "states", "meta", "refreshes",
                      "fresh_images")}
    ok = (finite and all(same.values())
          and all(len(f["history"]) == iters + 1 for f in full)
          and full[0]["refreshes"] >= 6
          and all(f["shard_slots"] == DP_TRAINER["pool"] // DP_RANKS
                  for f in full)
          and all(f["launches"]["nlm_gray_fwd"] >= iters
                  and f["launches"]["nlm_gray_bwd"] >= iters for f in full))
    emit({"phase": "dp_trainer", "nvidia_smi": smi, "ranks": DP_RANKS,
          "backend": "gloo", **DP_TRAINER,
          "global_batch": conf["trainer"]["batch"],
          "size": conf["trainer"]["size"], "detector": "yolov3 bf16",
          "history_finite": finite, "ranks_equal": same,
          "refreshes": full[0]["refreshes"],
          "sampled_slots": [s[0] for s in full[0]["seen"]],
          "launches": [f["launches"] for f in full],
          "iter_ms": [f["iter_ms"] for f in full],
          "seconds": [f["seconds"] for f in full], "ok": ok})
    if not ok:
        bad.append("dp_trainer")

    # ---- dp_trainer_vs_cpu: the card's two ranks against the CPU's ----
    tcmp = []
    for r in range(DP_RANKS):
        g, c = ranks[r]["trainer_vs_cpu"], cpu_ranks[r]
        rel = max(abs(hg[k] - hc[k]) / (abs(hc[k]) + 1e-6)
                  for hg, hc in zip(g["history"], c["history"]) for k in hc)
        img = float((g["images"] - c["images"]).abs().max())
        loss = float((g["loss_in"] - c["loss_in"]).abs().max()
                     / (c["loss_in"].abs().max() + 1e-6))
        ok = (g["seen"] == c["seen"] and g["states"] == c["states"]
              and g["meta"] == c["meta"] and rel <= 1e-3 and img <= 1e-3
              and loss <= 1e-3 and g["refreshes"] == c["refreshes"] >= 6
              and len(g["history"]) == iters + 1
              and g["launches"]["nlm_gray_fwd"] >= iters
              and g["launches"]["nlm_gray_bwd"] >= iters)
        tcmp.append({"rank": r, "history_rel_err": rel,
                     "pool_image_max_abs_err": img, "pool_loss_rel_err": loss,
                     "sampled_equal": g["seen"] == c["seen"],
                     "states_equal": g["states"] == c["states"],
                     "refreshes": [g["refreshes"], c["refreshes"]],
                     "launches": g["launches"], "iter_ms": g["iter_ms"],
                     "ok": ok})
        if not ok:
            bad.append(f"dp_trainer_vs_cpu rank {r}")
    emit({"phase": "dp_trainer_vs_cpu", "ranks": DP_RANKS, **DP_TRAINER,
          **{k: v for k, v in DP_TRAINER_VS_CPU.items() if k != "cfg"},
          "detector": "yolov3-tiny f32", "cpu_seconds": cpu_s,
          "sampled_slots": [s[0] for s in
                            ranks[0]["trainer_vs_cpu"]["seen"]],
          "tolerance": {"history_rtol": 1e-3, "pool_image_atol": 1e-3,
                        "pool_loss_rtol": 1e-3}, "by_rank": tcmp})

    # ---- dp_cli ----
    ok = (cli[1]["mesh"] == [1, "nccl" if CARD != "cpu" else "gloo"]
          and not cli_diffs and cli[1]["history"] == cli[0]["history"]
          and cli[0]["launches"] == cli[1]["launches"]
          and cli[1]["launches"]["nlm_gray_fwd"] == 3)
    emit({"phase": "dp_cli", "mesh": cli[1]["mesh"],
          "payload_diffs": cli_diffs[:10],
          "history_equal": cli[1]["history"] == cli[0]["history"],
          "iter_ms": {f"dp{d}": r["iter_ms"] for d, r in cli.items()},
          "launches": {f"dp{d}": r["launches"] for d, r in cli.items()},
          "seconds": cli_s, "ok": ok})
    if not ok:
        bad.append("dp_cli")

    # ---- dp_validation ----
    vals = [r["val"] for r in ranks]
    ok = all(v["records"] == ref["val"]["records"]
             and v["map50"] == ref["val"]["map50"] for v in vals)
    emit({"phase": "dp_validation", "images": len(ref["val"]["records"]),
          "batch": SERVE_BATCH, "records_equal": ok,
          "map50": [v["map50"] for v in vals] + [ref["val"]["map50"]],
          "ms": [v["ms"] for v in vals], "single_ms": ref["val"]["ms"],
          "launches": [v["launches"] for v in vals]})
    if not ok:
        bad.append("dp_validation")

    # ---- dp_detector, dp_segment, dp_classify ----
    for kind, name in (("det", "dp_detector"), ("seg", "dp_segment"),
                       ("cls", "dp_classify")):
        want = ref[kind]
        loss_rel = [abs(r[kind]["loss"] - want["loss"]) / abs(want["loss"])
                    for r in ranks]
        model = _close_models(ranks[0][kind]["model"], want["model"])
        ema = _close_models(ranks[0][kind]["ema"], want["ema"])
        replicas = (ranks[0][kind]["model_digest"]
                    == ranks[1][kind]["model_digest"])
        ok = (max(loss_rel) <= DP_LOSS_RTOL and model[0] <= DP_PARAM_ATOL
              and ema[0] <= DP_PARAM_ATOL and replicas)
        emit({"phase": name, "global_batch": conf[kind]["batch"],
              "size": conf[kind]["size"], "loss_rel_err": loss_rel,
              "model_excess": model, "ema_excess": ema,
              "replicas_equal": replicas,
              "ms": [r[kind]["ms"] for r in ranks], "single_ms": want["ms"],
              "tolerance": {"loss_rtol": DP_LOSS_RTOL,
                            "param_rtol": DP_PARAM_RTOL,
                            "param_atol": DP_PARAM_ATOL}, "ok": ok})
        if not ok:
            bad.append(name)
    emit({"phase": "dp_seconds", "references": ref_s, "card_ranks": card_s,
          "cpu_ranks": cpu_s, "cli": cli_s})
    if bad:
        raise AssertionError(f"data parallelism: {bad}")
    paths = {}
    for r in range(DP_RANKS):
        for d in conf["rl"]["dtypes"]:
            paths[f"dp_train_step_{d}/rank{r}"] = ranks[r][f"rl_{d}"][
                "launches"]
        paths[f"dp_trainer/rank{r}"] = ranks[r]["trainer"]["launches"]
        paths[f"dp_validation/rank{r}"] = ranks[r]["val"]["launches"]
    paths["dp_cli"] = cli[1]["launches"]
    return paths


# the parallel axes (phase 30): two gloo ranks on the one card, each a
# (1 x 2) mesh; sizes at the main paths' widths
AXES_RANKS = 2
SP_FRAMES = (2,) + UHD                  # 2 x 2160 x 3840, 199 MB
SP_CHAIN = ("exposure", "improved_wb", "ccm", "gamma", "denoise", "sharpen")
SP_ATOL = 1e-6      # ccm's library product and K1 on a slab; else exact
EP_BATCH, EP_SIZE = SERVE_BATCH, SERVE_SIZE
EP_RTOL, EP_ATOL = 1e-5, 1e-6           # JAX's own (tests/test_ep_pp.py)
PP_STAGES = ("denoise:0.4", "sharpen_usm:1.2,0.6")
PP_WINDOW, PP_BATCH = 4, 2
TP_STEPS = 2
TP_LOSS_RTOL = 1e-5
# the spec, size and batch of the tp phase and of the NCCL CLI run (the
# detector phases'); a CPU rehearsal sets them small
TP_SPEC_NAME = "yolov3"


def _axes_dir():
    root = Path(__file__).resolve().parent / "build" / "axes_smoke"
    root.mkdir(parents=True, exist_ok=True)
    return root


def _axes_conf():
    """What the ranks read (a CPU rehearsal changes the constants in the
    parent only)."""
    from adaptiveisp_tpu_torch.detect.spec import resolve_spec

    build_dir = Path(__file__).resolve().parent / "build"
    root = _axes_dir()
    return {"device": CARD if CARD == "cpu" else "cuda:0", "root": str(root),
            "sp": dict(frames=SP_FRAMES, chain=SP_CHAIN, seed=31),
            "ep": dict(batch=EP_BATCH, size=EP_SIZE, seed=32),
            "pp": dict(source=str(build_dir / "render_smoke" / "imgs"),
                       stages=PP_STAGES, window=PP_WINDOW, batch=PP_BATCH),
            "hr": dict(data=str(build_dir / "hr_smoke" / "data.yaml"),
                       weights=str(build_dir / "hr_smoke" / "agent.pt"),
                       size=SERVE_SIZE, steps=STEPS),
            "tp": dict(spec=resolve_spec(TP_SPEC_NAME), size=DET_SIZE,
                       batch=DET_BATCH, steps=TP_STEPS,
                       data=str(build_dir / "det_smoke" / "train"
                                / "images"),
                       batch_file=str(root / "tp_batch.pt"),
                       ref_file=str(root / "tp_ref.pt"))}


def _sp_inputs(c, device):
    """The sp phase's frames (drawn on the device from a seed, the same on
    every rank) and each stage's per-image parameters."""
    import torch

    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops.bank import get_spec

    cfg = Config()
    g = torch.Generator(device=device).manual_seed(c["seed"])
    frames = torch.rand(tuple(c["frames"]) + (3,), generator=g,
                        device=device)
    rng = np.random.RandomState(c["seed"])
    params = []
    for name in c["chain"]:
        spec = get_spec(cfg, name)
        feat = torch.from_numpy(rng.randn(c["frames"][0], spec.n_params)
                                .astype(np.float32) * 0.5)
        params.append(spec.squash(cfg, feat).to(device))
    return cfg, frames, params


def _ep_inputs(c, device):
    """Config()'s ten filters' squashed parameters for a batch, one-hot
    weights with two images on denoise, and soft weights."""
    import torch

    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops.bank import filter_specs

    cfg = Config()
    g = torch.Generator(device=device).manual_seed(c["seed"])
    n = c["batch"]
    img = torch.rand((n, c["size"], c["size"], 3), generator=g,
                     device=device)
    rng = np.random.RandomState(c["seed"])
    params = [s.squash(cfg, torch.from_numpy(
        rng.randn(n, s.n_params).astype(np.float32) * 0.5)).to(device)
        for s in filter_specs(cfg)]
    k = cfg.n_filters
    actions = rng.randint(0, k, n)
    actions[:2] = cfg.filters.index("denoise")
    onehot = torch.from_numpy(np.eye(k, dtype=np.float32)[actions])
    soft = rng.rand(n, k).astype(np.float32)
    soft = torch.from_numpy(soft / soft.sum(1, keepdims=True))
    return cfg, img, params, onehot.to(device), soft.to(device)


def _sp_render_rank(c, device):
    """make_sharded_render on the rank's rows of the 4K frames (the main
    run: K1 once), then each stage on the rank's rows of the whole
    chain's input to that stage, against the whole frames' stage."""
    import torch

    from adaptiveisp_tpu_torch.ops.bank import make_sharded_render, render_fixed
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    mesh = mesh_lib.make_mesh_2d(1, AXES_RANKS, device=device,
                                 backend="gloo")
    cfg, frames, params = _sp_inputs(c, device)
    height = frames.shape[1]
    rows = mesh_lib.Rows(mesh, height)
    lo, hi = rows.bounds
    block = frames[:, lo:hi].contiguous()
    fn = make_sharded_render(cfg, mesh, c["chain"])
    with torch.no_grad():
        fn(block, params, height)
        _sync(device)
        build.reset_launches()
        out, ms = _timed_ms(lambda: fn(block, params, height), device)
        launches = dict(build.LAUNCHES)
        stage_err, x = {}, frames
        for name, p in zip(c["chain"], params):
            y = render_fixed(cfg, x, name, p)
            got = render_fixed(cfg, x[:, lo:hi].contiguous(), name, p,
                               rows=rows)
            stage_err[name] = float((got - y[:, lo:hi]).abs().max())
            x = y
        err = float((out - x[:, lo:hi]).abs().max())
        whole = mesh_lib.gather_rows(mesh, out, height)
        gathered = bool(torch.equal(whole[:, lo:hi], out))
    return {"rows": [lo, hi], "ms": ms, "launches": launches,
            "max_abs_err": err, "stage_max_abs_err": stage_err,
            "gathered_equal": gathered}


def _ep_blend_rank(c, device):
    """make_ep_blend_render (5 filters a rank) on one-hot weights (the main
    run) and soft weights against render_blend in one process."""
    import torch

    from adaptiveisp_tpu_torch.ops.bank import render_blend
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.ep import make_ep_blend_render
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    mesh = mesh_lib.make_mesh_dp_ep(1, AXES_RANKS, device=device,
                                    backend="gloo")
    cfg, img, params, onehot, soft = _ep_inputs(c, device)
    fn = make_ep_blend_render(cfg, mesh)
    out = {}
    with torch.no_grad():
        fn(img, params, soft)
        _sync(device)
        for name, w in (("onehot", onehot), ("soft", soft)):
            build.reset_launches()
            got, ms = _timed_ms(lambda: fn(img, params, w), device)
            launches = dict(build.LAUNCHES)
            want = render_blend(cfg, img, params, w)
            d = (got - want).abs()
            out[name] = {"ms": ms, "launches": launches,
                         "max_abs_err": float(d.max()),
                         "excess": float((d - EP_RTOL * want.abs()).max())}
    return out


def _pp_cli_args(c, device, out, pipe):
    args = ["--source", c["source"], "--device", str(device), "--out", out,
            "--exist-ok", "--batch", str(c["batch"])]
    for s in c["stages"]:
        args += ["--stage", s]
    if pipe:
        args += ["--pipe", str(len(c["stages"])), "--window",
                 str(c["window"])]
    return args


def _pp_cli_rank(c, root, device):
    """render_isp --pipe 2 --window 4 in this rank (the CLI joins the
    ranks' group): its wall ms and launch counts."""
    import contextlib

    from adaptiveisp_tpu_torch import render_isp
    from adaptiveisp_tpu_torch.ops.cuda import build

    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        render_isp.main(_pp_cli_args(c, device, os.path.join(root, "pp"),
                                     True))
    _sync(device)
    return {"ms": (time.perf_counter() - t0) * 1e3,
            "launches": dict(build.LAUNCHES)}


def _hr_frames(run):
    """Run ``run()`` with eval.hr_render's writes captured (the frames
    before PNG quantisation, by relative path)."""
    from adaptiveisp_tpu_torch.eval import hr_render

    saved, frames = hr_render.save_img, {}

    def capture(img, path):
        frames[os.path.join(*Path(path).parts[-2:])] = np.array(img)
        saved(img, path)

    hr_render.save_img = capture
    try:
        run()
    finally:
        hr_render.save_img = saved
    return frames


def _sp_hr_args(c, device, out, shards):
    return ["--task", "val", "--data_cfg", c["data"], "--model_weights",
            c["weights"], "--imgsz", str(c["size"]), "--steps",
            str(c["steps"]), "--device", str(device), "--val_save_path", out,
            "--spatial_shard", str(shards)]


def _sp_hr_rank(c, root, device):
    """train_isp --task val --spatial_shard 2 in this rank: its frames
    (rank 0 writes), wall ms and launch counts."""
    from adaptiveisp_tpu_torch import train_isp
    from adaptiveisp_tpu_torch.ops.cuda import build

    build.reset_launches()
    t0 = time.perf_counter()
    frames = _hr_frames(lambda: train_isp.main(_sp_hr_args(
        c, device, os.path.join(root, "hr_sp"), AXES_RANKS)))
    _sync(device)
    return {"ms": (time.perf_counter() - t0) * 1e3,
            "launches": dict(build.LAUNCHES), "frames": frames}


def _tp_trainer(c, device, mesh=None):
    """The detector trainer at the tp phase's width (augmentation off)."""
    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
    from adaptiveisp_tpu_torch.detect.train_detector import DetTrainConfig
    from adaptiveisp_tpu_torch.detect.train_loop import DetectorTrainer

    model = api.load_detector(spec=c["spec"], seed=0, device=device).model
    tds = DetectorDataset(c["data"], img_size=c["size"],
                          batch_size=c["batch"], augment=False,
                          nc=c["spec"]["nc"])
    return DetectorTrainer(model, c["spec"], tds,
                           cfg=DetTrainConfig(epochs=1, batch_size=c["batch"]),
                           loggers=False, device=device, mesh=mesh)


def _tp_steps(tr, c, device, mesh=None):
    """c["steps"] steps on the saved batch (the rank's rows over a mesh):
    losses and ms."""
    import torch

    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    arrays = tuple(torch.load(c["batch_file"], weights_only=False))
    args = (mesh_lib.shard_batch(mesh, arrays) if mesh is not None else
            tuple(torch.from_numpy(a).to(device) for a in arrays))
    losses, ms = [], []
    for _ in range(c["steps"]):
        _sync(device)
        (tr.state, out), t = _timed_ms(lambda: tr.step_fn(tr.state, *args),
                                       device)
        losses.append(float(out["loss"]))
        ms.append(t)
    return losses, ms


def _tp_rank(c, device):
    """shard_detector_train_step (through DetectorTrainer(mesh=)) on a
    (1 x 2) data x model mesh: the steps, each rank's bytes, and on rank 0
    the gathered model and EMA against the single process's."""
    import torch

    from adaptiveisp_tpu_torch import tensor_parallel as tp_lib
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    mesh = mesh_lib.make_mesh_dp_tp(1, AXES_RANKS, device=device,
                                    backend="gloo")
    tr = _tp_trainer(c, device, mesh)
    losses, ms = _tp_steps(tr, c, device, mesh)
    specs = tr.model._tp_specs
    split = {k for k, s in specs.items() if s}
    local = tr.model.state_dict()
    moments = {n: st for n, st in zip(
        [n for n, _ in tr.model.named_parameters()],
        [tr.state.optimizer.state[p] for p in tr.model.parameters()])}
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    out = {"losses": losses, "ms": ms, "bytes": dict(
        tp_lib.state_bytes(tr.state),
        split_params=nbytes(local[k] for k in split if k in moments),
        split_moments=nbytes(v for k in split if k in moments
                             for v in moments[k].values()))}
    model = _cpu_sd(tr._whole(tr.model.state_dict()))
    ema = _cpu_sd(tr._whole(tr.state.ema.params))
    if mesh.is_main:
        ref = torch.load(c["ref_file"], weights_only=False)
        out["model_excess"] = _close_models(model, ref["model"])
        out["ema_excess"] = _close_models(ema, ref["ema"])
        out["loss_rel_err"] = [abs(a - b) / abs(b) for a, b in
                               zip(losses, ref["losses"])]
    return out


def axes_rank(root):
    """One rank of the parallel-axes phases (started by ``phase_axes``):
    sp_render, ep_blend, tp_detector, pp_cli and sp_hr over (1 x 2) gloo
    meshes, each main run's launch counts read around it; writes
    rank<r>.pt under ``root``."""
    import torch
    import torch.distributed as dist

    conf = torch.load(os.path.join(root, "conf.pt"), weights_only=False)
    dev = conf["device"]
    if dev.startswith("cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // AXES_RANKS))
    seconds, out = {}, {}
    for name, fn in (("sp_render", lambda: _sp_render_rank(conf["sp"], dev)),
                     ("ep_blend", lambda: _ep_blend_rank(conf["ep"], dev)),
                     ("tp_detector", lambda: _tp_rank(conf["tp"], dev)),
                     ("pp_cli", lambda: _pp_cli_rank(conf["pp"], root, dev)),
                     ("sp_hr", lambda: _sp_hr_rank(conf["hr"], root, dev))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
        if dev.startswith("cuda"):
            torch.cuda.empty_cache()
    out["seconds"] = seconds
    torch.save(out, os.path.join(root, f"rank{dist.get_rank()}.pt"))


def _gloo_p2p_on_cuda(device):
    """Whether gloo sends a CUDA tensor from one rank to another (two
    ranks started here); the pp ring stages through host memory when it
    does not."""
    import torch

    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    if not str(device).startswith("cuda"):
        return None
    root = _axes_dir()
    try:
        mesh_lib.launch("chip_smoke:gloo_p2p_rank", AXES_RANKS, str(root),
                        device="cuda:0", backend="gloo").wait(timeout=120)
    except (RuntimeError, TimeoutError) as e:
        return f"no: {str(e)[:200]}"
    got = torch.load(root / "p2p.pt", weights_only=False)
    return "yes" if got else "no: wrong values"


def gloo_p2p_rank(root):
    """Rank 0 sends a CUDA tensor to rank 1 over gloo; rank 1 writes
    whether it arrived."""
    import torch
    import torch.distributed as dist

    x = torch.arange(8, dtype=torch.float32, device="cuda:0")
    if dist.get_rank() == 0:
        dist.send(x, 1)
    else:
        y = torch.empty_like(x)
        dist.recv(y, 0)
        torch.save(bool(torch.equal(x, y)), os.path.join(root, "p2p.pt"))


def _tp_cli(c):
    """``train_loop --tp 1 --dp 1`` (a 1 x 1 data x model mesh: NCCL,
    world size 1) against no mesh, one epoch of the detector phases'
    images at the tp phase's batch, cuDNN deterministic; (each run's
    seconds, the tensors of last.pt that differ)."""
    import contextlib

    import torch
    import torch.distributed as dist

    from adaptiveisp_tpu_torch.detect import train_loop

    root = _axes_dir()
    runs, seconds = {}, {}
    try:
        for tp in (0, 1):
            t0 = time.perf_counter()
            save = root / f"tp_cli{tp}"
            with contextlib.redirect_stdout(sys.stderr):
                train_loop.main([
                    "--data", c["data"], "--spec", TP_SPEC_NAME,
                    "--imgsz", str(c["size"]), "--batch-size",
                    str(c["batch"]), "--epochs", "1", "--save-dir",
                    str(save), "--exist-ok", "--device", CARD,
                    "--noautoanchor"] + (["--tp", "1", "--dp", "1"]
                                         if tp else []))
            _sync(CARD)
            seconds[tp] = time.perf_counter() - t0
            runs[tp] = torch.load(save / "last.pt", weights_only=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    diffs = [f"{part}.{k}" for part in ("model", "ema")
             for k, v in runs[0][part].items()
             if not torch.equal(v, runs[1][part][k])]
    return seconds, diffs


def phase_axes(smi):
    """The parallel-axes phases (module docstring, phase 30): the
    single-process references on the card, one launch of two gloo ranks
    on the card (``axes_rank``), the single-process CLI runs against the
    ranks' and ``train_loop --tp 1 --dp 1`` on NCCL.  Returns each main
    run's launch counts by rank."""
    import contextlib
    import gc
    import shutil

    import torch
    from PIL import Image

    from adaptiveisp_tpu_torch import parallel, render_isp, train_isp
    from adaptiveisp_tpu_torch import tensor_parallel as tp_lib
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.data.detector_dataset import DetectorDataset
    from adaptiveisp_tpu_torch.ops.bank import render_blend, render_pipeline
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    conf = _axes_conf()
    root = Path(conf["root"])
    for d in ("pp", "pp_single", "hr_sp", "hr_single"):
        shutil.rmtree(root / d, ignore_errors=True)
    torch.save(conf, root / "conf.pt")
    t = conf["tp"]
    torch.save(list(next(DetectorDataset(
        t["data"], img_size=t["size"], batch_size=t["batch"], augment=False,
        nc=t["spec"]["nc"]).epoch_batches(shuffle=False))), t["batch_file"])

    # ---- the single process's runs on the card ----
    t0 = time.perf_counter()
    single = {}
    with torch.no_grad():
        cfg, frames, params = _sp_inputs(conf["sp"], CARD)
        stages = list(zip(conf["sp"]["chain"], params))
        render_pipeline(cfg, frames, stages, allow_fused=False)
        _, single["sp_render_ms"] = _timed_ms(lambda: render_pipeline(
            cfg, frames, stages, allow_fused=False), CARD)
        del frames
        cfg, img, params, onehot, soft = _ep_inputs(conf["ep"], CARD)
        render_blend(cfg, img, params, onehot)
        _, single["ep_blend_ms"] = _timed_ms(
            lambda: render_blend(cfg, img, params, onehot), CARD)
        del img, params
    tr = _tp_trainer(t, CARD)
    losses, single["tp_step_ms"] = _tp_steps(tr, t, CARD)
    from adaptiveisp_tpu_torch import tensor_parallel as tp_lib

    single["tp_bytes"] = tp_lib.state_bytes(tr.state)
    # the single process's bytes of the tensors a 2-way model axis splits
    two = parallel.Mesh(0, AXES_RANKS, torch.device(CARD),
                        axis_names=(parallel.DATA_AXIS, parallel.MODEL_AXIS),
                        shape=(1, AXES_RANKS), coords=(0, 0),
                        groups=(None, None))
    split = {k for k, s in tp_lib.tp_state_sharding(two, tr.model).items()
             if s}
    named = dict(tr.model.named_parameters())
    single["tp_split"] = {
        "split_params": sum(named[k].numel() * 4 for k in split
                            if k in named),
        "split_moments": sum(v.numel() * v.element_size() for k in split
                             if k in named for v in
                             tr.state.optimizer.state[named[k]].values())}
    torch.save({"losses": losses, "model": _cpu_sd(tr.model.state_dict()),
                "ema": _cpu_sd(tr.state.ema.params)}, t["ref_file"])
    del tr, named
    p = conf["pp"]
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        render_isp.main(_pp_cli_args(p, CARD, str(root / "pp_single"),
                                     False))
    _sync(CARD)
    single["pp_cli_ms"] = (time.perf_counter() - t1) * 1e3
    h = conf["hr"]
    t1 = time.perf_counter()
    hr_single = _hr_frames(lambda: train_isp.main(_sp_hr_args(
        h, CARD, str(root / "hr_single"), 1)))
    _sync(CARD)
    single["sp_hr_ms"] = (time.perf_counter() - t1) * 1e3
    gc.collect()
    if CARD != "cpu":
        torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0

    # ---- the two ranks ----
    t0 = time.perf_counter()
    mesh_lib.launch("chip_smoke:axes_rank", AXES_RANKS, str(root),
                    device=conf["device"], backend="gloo").wait()
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False)
             for r in range(AXES_RANKS)]
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2p = _gloo_p2p_on_cuda(CARD)
    tp_cli_s, tp_cli_diffs = _tp_cli(t)
    cli_s = time.perf_counter() - t0
    bad = []

    # ---- sp_render ----
    sp = [r["sp_render"] for r in ranks]
    ok = (all(s["max_abs_err"] <= SP_ATOL and s["gathered_equal"]
              and s["launches"]["nlm_gray_fwd"] == 1 for s in sp)
          and all(s["stage_max_abs_err"][n] == 0.0 for s in sp
                  for n in SP_CHAIN if n not in ("ccm", "denoise")))
    worst = max(((e, n) for s in sp
                 for n, e in s["stage_max_abs_err"].items()), default=None)
    emit({"phase": "sp_render", "nvidia_smi": smi, "ranks": AXES_RANKS,
          "backend": "gloo", "frames": list(conf["sp"]["frames"]),
          "chain": list(SP_CHAIN), "rows": [s["rows"] for s in sp],
          "max_abs_err": [s["max_abs_err"] for s in sp],
          "worst_stage": worst,
          "stage_max_abs_err": [s["stage_max_abs_err"] for s in sp],
          "launches": [s["launches"] for s in sp],
          "ms": [s["ms"] for s in sp], "single_ms": single["sp_render_ms"],
          "atol": SP_ATOL, "ok": ok})
    if not ok:
        bad.append("sp_render")

    # ---- sp_hr ----
    hr = [r["sp_hr"] for r in ranks]
    got = hr[0]["frames"]
    errs = {k: float(np.abs(got[k] - v).max()) for k, v in hr_single.items()
            if k in got}
    ok = (sorted(got) == sorted(hr_single) and bool(errs)
          and max(errs.values()) <= SP_ATOL and not hr[1]["frames"]
          and all(x["launches"]["nlm_gray_fwd"] > 0 for x in hr))
    emit({"phase": "sp_hr", "ranks": AXES_RANKS,
          "frames": len(hr_single), "frames_equal": sorted(got) == sorted(
              hr_single), "max_abs_err": max(errs.values(), default=None),
          "atol": SP_ATOL, "launches": [x["launches"] for x in hr],
          "ms": [x["ms"] for x in hr], "single_ms": single["sp_hr_ms"],
          "ok": ok})
    if not ok:
        bad.append("sp_hr")

    # ---- ep_blend ----
    ep = [r["ep_blend"] for r in ranks]
    cfg = Config()
    per_rank = cfg.n_filters // AXES_RANKS
    owner = cfg.filters.index("denoise") // per_rank
    ok = (all(e[w]["excess"] <= EP_ATOL for e in ep
              for w in ("onehot", "soft"))
          and [e["onehot"]["launches"]["nlm_gray_fwd"] for e in ep]
          == [1 if r == owner else 0 for r in range(AXES_RANKS)])
    emit({"phase": "ep_blend", "ranks": AXES_RANKS, "batch": EP_BATCH,
          "size": EP_SIZE, "filters_per_rank": per_rank,
          "denoise_rank": owner,
          **{w: {"max_abs_err": [e[w]["max_abs_err"] for e in ep],
                 "excess_over_rtol": [e[w]["excess"] for e in ep],
                 "launches": [e[w]["launches"] for e in ep],
                 "ms": [e[w]["ms"] for e in ep]}
             for w in ("onehot", "soft")},
          "single_ms": single["ep_blend_ms"],
          "tolerance": {"rtol": EP_RTOL, "atol": EP_ATOL}, "ok": ok})
    if not ok:
        bad.append("ep_blend")

    # ---- pp_cli ----
    pp = [r["pp_cli"] for r in ranks]
    names = sorted(os.listdir(root / "pp_single"))
    same = names == sorted(os.listdir(root / "pp")) and all(
        np.array_equal(np.asarray(Image.open(root / "pp" / n)),
                       np.asarray(Image.open(root / "pp_single" / n)))
        for n in names)
    # a window of PP_WINDOW microbatches of PP_BATCH frames a dispatch
    n_micro = -(-len(names) // (PP_WINDOW * PP_BATCH)) * PP_WINDOW
    ok = (same and len(names) == SERVE_BATCH
          and [x["launches"]["nlm_gray_fwd"] for x in pp] == [n_micro, 0])
    emit({"phase": "pp_cli", "ranks": AXES_RANKS, "stages": list(PP_STAGES),
          "window": PP_WINDOW, "batch": PP_BATCH, "frames": len(names),
          "pngs_equal": same, "microbatches": n_micro,
          "launches": [x["launches"] for x in pp],
          "ms": [x["ms"] for x in pp], "single_ms": single["pp_cli_ms"],
          "gloo_p2p_on_cuda": p2p, "ok": ok})
    if not ok:
        bad.append("pp_cli")

    # ---- tp_detector ----
    tp = [r["tp_detector"] for r in ranks]
    r0 = tp[0]
    half = all(x["bytes"][k] * AXES_RANKS == single["tp_split"][k]
               for x in tp for k in ("split_params", "split_moments"))
    ok = (half and max(r0["loss_rel_err"]) <= TP_LOSS_RTOL
          and r0["model_excess"][0] <= DP_PARAM_ATOL
          and r0["ema_excess"][0] <= DP_PARAM_ATOL
          and all(x["losses"] == r0["losses"] for x in tp)
          and not tp_cli_diffs)
    emit({"phase": "tp_detector", "ranks": AXES_RANKS, "mesh": [1, 2],
          "spec": TP_SPEC_NAME, "size": t["size"], "global_batch":
          t["batch"], "steps": TP_STEPS, "losses": r0["losses"],
          "loss_rel_err": r0["loss_rel_err"],
          "model_excess": r0["model_excess"], "ema_excess": r0["ema_excess"],
          "bytes": [x["bytes"] for x in tp], "single_bytes":
          dict(single["tp_bytes"], **single["tp_split"]),
          "split_halved": half, "ms": [x["ms"] for x in tp],
          "single_ms": single["tp_step_ms"],
          "cli_tp1_nccl": {"seconds": tp_cli_s, "last_pt_diffs":
                           tp_cli_diffs[:10]},
          "tolerance": {"loss_rtol": TP_LOSS_RTOL,
                        "param_rtol": DP_PARAM_RTOL,
                        "param_atol": DP_PARAM_ATOL}, "ok": ok})
    if not ok:
        bad.append("tp_detector")
    emit({"phase": "axes_seconds", "references": ref_s, "ranks": ranks_s,
          "by_rank": [r["seconds"] for r in ranks], "cli": cli_s})
    if bad:
        raise AssertionError(f"parallel axes: {bad}")
    paths = {}
    for r in range(AXES_RANKS):
        paths[f"sp_render/rank{r}"] = sp[r]["launches"]
        paths[f"sp_hr/rank{r}"] = hr[r]["launches"]
        paths[f"ep_blend/rank{r}"] = ep[r]["onehot"]["launches"]
        paths[f"pp_cli/rank{r}"] = pp[r]["launches"]
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        smi = timed("device", phase_device)
        timed("build", phase_build)
        kern = timed("kernel", phase_kernel)
        kern_bwd = timed("kernel_bwd", phase_kernel_bwd)
        kern_pipe = timed("kernel_pipeline", phase_kernel_pipeline)
        sym_path = timed("kernel_sym_path", phase_kernel_sym_path)
        launches = timed("serving", phase_serving)
        trains = [timed(f"train_{d}", phase_train, d) for d in ("bf16", "f32")]
        timed("train_vs_cpu", phase_train_vs_cpu)
        render = timed("render", phase_render)
        timed("fused_grad", phase_fused_grad)
        trainer, cli = timed("trainer", phase_trainer, smi)
        timed("trainer_vs_cpu", phase_trainer_vs_cpu)
        agent, det_sd, data_yaml, records, validation = timed(
            "validation", phase_validation, smi)
        val_cli = timed("val_cli", phase_val_cli, agent, det_sd, data_yaml,
                        records)
        hr, train_isp_val = timed("hr_render", phase_hr_render, agent)
        fixed, fixed_fused = timed("fixed_pipeline", phase_fixed_pipeline,
                                   smi, det_sd)
        timed("detector_train", phase_detector_train, smi)
        timed("detector_vs_cpu", phase_detector_vs_cpu)
        timed("detector_cli", phase_detector_cli)
        hub_weights = timed("hub", phase_hub)
        rest_launches, agent_file = timed("rest", phase_rest, hub_weights)
        cli_launches = timed("detect_cli", phase_detect_cli, hub_weights,
                             agent_file)
        timed("raw_unprocess", phase_raw_unprocess)
        timed("segment_train", phase_segment_train, smi)
        timed("segment_vs_cpu", phase_segment_vs_cpu)
        timed("segment_cli", phase_segment_cli)
        timed("classify_train", phase_classify_train, smi)
        timed("classify_vs_cpu", phase_classify_vs_cpu, hub_weights)
        export_launches = timed("export", phase_export, smi)
        timed("triton", phase_triton)
        timed("trace_breakdown", phase_trace_breakdown, smi)
        dp_launches = timed("dp", phase_dp, smi)
        axes_launches = timed("axes", phase_axes, smi)
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    emit({"phase_seconds": seconds,
          "since_start": time.perf_counter() - STARTED})
    main_paths = {"serving": launches,
                  **{f"train_{t['detector_dtype']}": t["launches"]
                     for t in trains},
                  "render": render, "trainer": trainer["launches"], **cli,
                  **{f"validation_{k}": v for k, v in validation.items()},
                  "val_cli": val_cli, "hr_render": hr,
                  "train_isp_val": train_isp_val, "fixed_pipeline": fixed,
                  "fixed_step_fused": fixed_fused, "rest": rest_launches,
                  "detect_cli": cli_launches, "export": export_launches,
                  **dp_launches, **axes_launches}

    def entry(name, counter, source, replaces, cases, err_key, paths,
              ms_key="ms"):
        main_case = cases["main"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(p[counter] for p in paths.values()),
                "launches_by_path": {k: p[counter] for k, p in paths.items()},
                "max_abs_err": max(cases[c][err_key] for c in cases),
                "ms": main_case[ms_key], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"], "library_ms": None}

    nlm_fwd = "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_fwd.cu"
    kernels = [
        entry("nlm_gray_fwd", "nlm_gray_fwd", nlm_fwd,
              "adaptiveisp_tpu/ops/pallas/nlm.py:72", kern,
              "max_abs_err_out", main_paths),
        entry("nlm_gray_bwd", "nlm_gray_bwd",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_bwd.cu",
              "adaptiveisp_tpu/ops/pallas/nlm.py:378", kern_bwd,
              "max_abs_err_drgb", main_paths),
        entry("pipeline_fwd", "pipeline_fwd",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/pipeline_fwd.cu",
              "adaptiveisp_tpu/ops/pallas/pipeline.py:166", kern_pipe,
              "max_abs_err", main_paths),
        # JAX's K3 (sym=True) is served by K1's kernel
        entry("nlm_gray_fwd(sym=True)", "nlm_gray_fwd", nlm_fwd,
              "adaptiveisp_tpu/ops/pallas/nlm.py:123", kern,
              "max_abs_err_out", {"kernel_sym": sym_path}, ms_key="sym_ms")]
    kernels[2]["call_ms"] = kern_pipe["main"]["call_ms"]
    kernels[0]["op_ms"] = kern["main"]["op_ms"]   # through the operator
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0]
    if unlaunched:
        print(f"chip_smoke: {unlaunched} launched on no path",
              file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
