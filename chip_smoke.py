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
     1e-4) and on a [1,6,9,3] image smaller than the halo; K4
     (the fused render pass) on the bench's 5-stage chain at [8,512,512,3]
     with per-image parameters, a pointwise stack on exact 0/1, out-of-range,
     grey and two-channel-tie pixels, and four sharpens interleaved with
     pointwise stages at [2,37,53,3] and [1,2160,3840,3]; K3 (the symmetric
     NLM forward) against the plain version and K1 in the same four cases,
     timed in turns with K1,
     then ``NLMGray(sym=True)`` forward and backward once (K3, then K2; the
     launch counts of this run are the ``kernel`` path);
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
then the kernels line (each kernel's launches by path: serving, train_bf16,
train_f32, render, kernel), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
without a CUDA device or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

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
MAIN_GATE = np.array([1, 0, 0.3, 1, 0, 1, 1, 0], np.float32)


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
    """The gated NLM forward (K1 and K3 compute the same function) for these
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
    import torch

    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray_fwd
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray_uw

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    result = {}
    for name, rgb, h, gate_np in _nlm_cases(rng, dev, [1, 0]):
        n, hgt, wid, _ = rgb.shape
        gate = torch.from_numpy(gate_np[:, None]).to(dev)
        u, w = nlm_gray_fwd(rgb, h, gate)
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
        ok = err_out <= 2e-5 and err_u <= 2e-5 and rel_w <= 1e-5 and off_zero
        rec = {"phase": "kernel", "kernel": "nlm_gray_fwd", "case": name,
               "shape": [n, hgt, wid, 3], "gate": gate_np.tolist(),
               "max_abs_err_out": err_out, "max_abs_err_u": err_u,
               "max_rel_err_w": rel_w, "gated_off_exact_zero": off_zero,
               "tolerance": {"out_atol": 2e-5, "u_atol": 2e-5,
                             "w_rtol": 1e-5}, "ok": ok}
        if name == "main":
            rec["ms"] = cuda_time_ms(lambda: nlm_gray_fwd(rgb, h, gate), 50)
            rec["plain_ms"] = cuda_time_ms(lambda: nlm_gray_uw(rgb, h), 20)
            rec.update(nlm_bound(int((gate_np != 0).sum()), n, hgt, wid))
        emit(rec)
        if not ok:
            raise AssertionError(f"nlm kernel disagrees with its plain "
                                 f"version ({name})")
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
    a pixel) and the parameter table read once; per pixel the least
    arithmetic of each stage (STAGE_OPS)."""
    px = n * h * w
    ops = sum(STAGE_OPS[nm][0] for nm in names)
    sfu = sum(STAGE_OPS[nm][1] for nm in names)
    return bound(px * 24 + n * n_params * 4, px * ops, px * sfu)


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
    allow_fused=False)``) on the card."""
    import torch

    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops.bank import render_pipeline
    from adaptiveisp_tpu_torch.ops.cuda.pipeline import (
        pack_params,
        render_pipeline_fused,
    )

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
        "sharpen4_4k": (rng.rand(1, *UHD, 3).astype(np.float32),
                        _sharpen4(1, rng)),
    }
    result = {}
    for name, (img_np, stages_np) in cases.items():
        img = torch.from_numpy(img_np).to(dev)
        stages = [(nm, torch.from_numpy(p).to(dev)) for nm, p in stages_np]
        got = render_pipeline_fused(cfg, img, stages)
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
        if name in ("main", "sharpen4_4k"):
            rec["ms"] = cuda_time_ms(
                lambda: render_pipeline_fused(cfg, img, stages), PIPE_REPS)
            rec["plain_ms"] = cuda_time_ms(
                lambda: render_pipeline(cfg, img, stages, allow_fused=False),
                20)
            n, h, w, _ = img.shape
            rec.update(pipeline_bound(names, n, h, w,
                                      pack_params(cfg, img, stages).shape[1]))
        emit(rec)
        if not ok:
            raise AssertionError(f"render kernel disagrees with its plain "
                                 f"version ({name})")
        result[name] = rec
    return result


def phase_kernel_sym():
    """K3 against its plain version (``nlm_gray_uw``) and against K1 on the
    card; K3 and K1 timed in turns (K1, K3, K3, K1).  Then the K3 path:
    ``NLMGray`` with ``sym=True`` forward and backward once (K3, then K2),
    launch counts read around it, against autograd of the plain chain."""
    import torch

    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.cuda.nlm import NLMGray, nlm_gray_fwd
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray, nlm_gray_uw

    dev = torch.device("cuda")
    rng = np.random.RandomState(40)
    result = {}
    for name, rgb, h, gate_np in _nlm_cases(rng, dev, [1, 0]):
        n, hgt, wid, _ = rgb.shape
        gate = torch.from_numpy(gate_np[:, None]).to(dev)
        u3, w3 = nlm_gray_fwd(rgb, h, gate, sym=True)
        u1, w1 = nlm_gray_fwd(rgb, h, gate)
        torch.cuda.synchronize()
        u_p, w_p = nlm_gray_uw(rgb, h)
        on = (gate != 0).reshape(n, 1, 1, 1)
        u_p, w_p = torch.where(on, u_p, 0.0), torch.where(on, w_p, 0.0)
        err_u = float((u3 - u_p).abs().max())
        err_k1 = float((u3 - u1).abs().max())
        rel_w = float(((w3 - w_p).abs() / w_p.abs().clamp_min(1e-30))
                      [on.expand_as(w3)].max())
        rel_w_k1 = float(((w3 - w1).abs() / w1.abs().clamp_min(1e-30))
                         [on.expand_as(w3)].max())
        off = ~on.reshape(n)
        off_zero = bool(not torch.any(u3[off]) and not torch.any(w3[off]))
        ok = (err_u <= 2e-5 and err_k1 <= 5e-6 and rel_w <= 1e-5
              and off_zero)
        rec = {"phase": "kernel", "kernel": "nlm_gray_fwd_sym", "case": name,
               "shape": [n, hgt, wid, 3], "gate": gate_np.tolist(),
               "max_abs_err_u": err_u, "max_abs_err_u_vs_k1": err_k1,
               "max_rel_err_w": rel_w, "max_rel_err_w_vs_k1": rel_w_k1,
               "gated_off_exact_zero": off_zero,
               "tolerance": {"u_atol": 2e-5, "u_vs_k1_atol": 5e-6,
                             "w_rtol": 1e-5}, "ok": ok}
        if name == "main":
            k1a = cuda_time_ms(lambda: nlm_gray_fwd(rgb, h, gate), 50)
            k3a = cuda_time_ms(lambda: nlm_gray_fwd(rgb, h, gate, sym=True),
                               50)
            k3b = cuda_time_ms(lambda: nlm_gray_fwd(rgb, h, gate, sym=True),
                               50)
            k1b = cuda_time_ms(lambda: nlm_gray_fwd(rgb, h, gate), 50)
            rec.update({"ms": float(np.median([k3a, k3b])),
                        "ms_turns": {"k1": [k1a, k1b], "k3": [k3a, k3b]},
                        "k1_ms": float(np.median([k1a, k1b])),
                        "plain_ms": cuda_time_ms(
                            lambda: nlm_gray_uw(rgb, h), 5)})
            rec.update(nlm_bound(int((gate_np != 0).sum()), n, hgt, wid))
        emit(rec)
        if not ok:
            raise AssertionError(f"symmetric nlm kernel disagrees ({name})")
        result[name] = rec

    # the K3 path: NLMGray(sym=True), forward and backward
    rgb, h = _nlm_inputs(rng, 2, 64, 96, dev)
    g = torch.from_numpy(rng.randn(2, 64, 96, 3).astype(np.float32)).to(dev)
    gate = torch.ones((2, 1), device=dev)
    x = rgb.clone().requires_grad_(True)
    hk = h.clone().requires_grad_(True)
    torch.cuda.synchronize()
    build.reset_launches()
    out = NLMGray.apply(x, hk, gate, True)
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
    ok = (launches == only(nlm_gray_fwd_sym=1, nlm_gray_bwd=1)
          and err_out <= 2e-5 and err_dr <= 2e-5 and dh_ok)
    emit({"phase": "kernel_sym_path", "shape": [2, 64, 96, 3],
          "launches": launches, "max_abs_err_out": err_out,
          "max_abs_err_drgb": err_dr, "dh": hk.grad.flatten().tolist(),
          "dh_plain": hp.grad.flatten().tolist(),
          "tolerance": {"out_atol": 2e-5, "drgb_atol": 2e-5,
                        "dh_rtol": 2e-4, "dh_atol": 1e-5}, "ok": ok})
    if not ok:
        raise AssertionError("NLMGray(sym=True) disagrees with the plain "
                             "chain or launched the wrong kernels")
    return result, launches


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
    isp = api.load_adaptive_isp(cfg, steps=STEPS, seed=0, device="cuda")
    det = api.load_detector(YOLOV3_SPEC, seed=0, device="cuda")
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
    cpu = api.load_adaptive_isp(cfg, steps=1, seed=0, device="cpu")
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
    phase_profile(isp, det, images, nms, runs["forced_denoise"]["batch_ms"])
    return launches


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

    agent = api.load_adaptive_isp(cfg, seed=seed, device=device).agent
    value = api.load_value(cfg, seed=seed + 1, device=device)
    det = api.load_detector(YOLOV3_SPEC, seed=seed + 2, device=device,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        smi = phase_device()
        phase_build()
        kern = phase_kernel()
        kern_bwd = phase_kernel_bwd()
        kern_pipe = phase_kernel_pipeline()
        kern_sym, sym_path = phase_kernel_sym()
        launches = phase_serving()
        trains = [phase_train(d) for d in ("bf16", "f32")]
        phase_train_vs_cpu()
        render = phase_render()
        phase_fused_grad()
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    by_path = {"serving": launches,
               **{f"train_{t['detector_dtype']}": t["launches"]
                  for t in trains},
               "render": render, "kernel": sym_path}

    def entry(name, source, replaces, cases, err_key):
        main_case = cases["main"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {k: p[name] for k, p in by_path.items()},
                "max_abs_err": max(cases[c][err_key] for c in cases),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"], "library_ms": None}

    kernels = [
        entry("nlm_gray_fwd",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_fwd.cu",
              "adaptiveisp_tpu/ops/pallas/nlm.py:72", kern,
              "max_abs_err_out"),
        entry("nlm_gray_bwd",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_bwd.cu",
              "adaptiveisp_tpu/ops/pallas/nlm.py:378", kern_bwd,
              "max_abs_err_drgb"),
        entry("pipeline_fwd",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/pipeline_fwd.cu",
              "adaptiveisp_tpu/ops/pallas/pipeline.py:166", kern_pipe,
              "max_abs_err"),
        entry("nlm_gray_fwd_sym",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_fwd_sym.cu",
              "adaptiveisp_tpu/ops/pallas/nlm.py:123", kern_sym,
              "max_abs_err_u")]
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
