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
     version's time and the card's bound for the same work;
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
then the kernels line, the card's name and power limit, and as the last line
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
FORCED = [4, -1, -1, -1, -1]   # step 0 = denoise for every image
REPS = 5
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
MAIN_GATE = np.array([1, 0, 0.3, 1, 0, 1, 1, 0], np.float32)


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    """The gated NLM forward for these inputs: each input read once, each
    output written once; per gated-on pixel and offset the least arithmetic
    is 2 (difference, square) + 8 (separable 5x5 box sum) + 3 (sqrt,
    divide, exp) + 7 (weight sum and three multiply-adds) = 20 operations,
    3 of them on the special-function units."""
    px_on, px = n_on * h * w, n * h * w
    return bound(px_on * 12 + px * 16 + n * 8, px_on * 121 * 20,
                 px_on * 121 * 3)


def nlm_bwd_bound(n_on: int, n: int, h: int, w: int):
    """The gated NLM backward for these inputs: rgb, v and U (12 bytes a
    pixel each) and W (4) read once for the gated-on images, dL/drgb (12)
    written for every image.  Per gated-on pixel and offset the least
    arithmetic is 10 (difference, square, separable 5x5 box sum) + 3 (sqrt,
    divide by hh, exp) + 6 (g_w: three multiply-adds) + 1 (g_w w) + 2
    (strength term and its sum) + 3 (db: two multiplies, a divide) + 8 (box
    sum of db) + 3 (z = 2 diff dd2) + 2 (z(p) - z(p + d) into dL/dy) + 6
    (three direct multiply-adds) = 44 operations, 4 of them (sqrt, exp, two
    divisions) on the special-function units."""
    px_on, px = n_on * h * w, n * h * w
    return bound(px_on * (12 * 3 + 4) + px * 12 + n * 12,
                 px_on * 121 * 44, px_on * 121 * 4)


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


def phase_kernel_bwd():
    """K2 against its plain twin (autograd of the plain chain) on the card,
    with v = g * clip-gradient mask of U for a seeded normal g."""
    import torch

    from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray_bwd, nlm_gray_fwd
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray_bwd_plain
    from adaptiveisp_tpu_torch.ops.math import clip_grad_mask

    dev = torch.device("cuda")
    rng = np.random.RandomState(10)
    cases = {"main": (MAIN_GATE, (8, 512, 512)),
             "odd": (np.array([1, 0.3], np.float32), (2, 37, 53))}
    result = {}
    for name, (gate_np, (n, hgt, wid)) in cases.items():
        rgb, h = _nlm_inputs(rng, n, hgt, wid, dev)
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
    cases = {
        "main": (MAIN_GATE, (8, 512, 512)),
        "odd": (np.array([1, 0], np.float32), (2, 37, 53)),
    }
    result = {}
    for name, (gate_np, (n, hgt, wid)) in cases.items():
        rgb = torch.from_numpy(rng.uniform(-0.05, 1.05, (n, hgt, wid, 3))
                               .astype(np.float32)).to(dev)
        h_np = rng.uniform(0.02, 1.0, (n, 1)).astype(np.float32)
        h_np[min(3, n - 1)] = 0.0   # a gated-on image with zero strength
        h = torch.from_numpy(h_np).to(dev)
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
    if launches != {"nlm_gray_fwd": TRAIN_STEPS, "nlm_gray_bwd": TRAIN_STEPS}:
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
          and launches == {"nlm_gray_fwd": 1, "nlm_gray_bwd": 1})
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
        launches = phase_serving()
        trains = [phase_train(d) for d in ("bf16", "f32")]
        phase_train_vs_cpu()
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    by_path = {"serving": launches,
               **{f"train_{t['detector_dtype']}": t["launches"]
                  for t in trains}}

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

    emit({"kernels": [
        entry("nlm_gray_fwd",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_fwd.cu",
              "adaptiveisp_tpu/ops/pallas/nlm.py:72", kern,
              "max_abs_err_out"),
        entry("nlm_gray_bwd",
              "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_bwd.cu",
              "adaptiveisp_tpu/ops/pallas/nlm.py:378", kern_bwd,
              "max_abs_err_drgb")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
