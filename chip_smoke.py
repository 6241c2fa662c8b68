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


def nlm_bound(n_on: int, n: int, h: int, w: int):
    """Least time of the gated NLM forward for these inputs: each input read
    once, each output written once; per gated-on pixel and offset the
    least arithmetic is 2 (difference, square) + 8 (separable 5x5 box sum)
    + 3 (sqrt, divide, exp) + 7 (weight sum and three multiply-adds) = 20
    operations, 3 of them on the special-function units."""
    px_on, px = n_on * h * w, n * h * w
    nbytes = px_on * 12 + px * 16 + n * 8
    ops = px_on * 121 * 20
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "sfu_ms": px_on * 121 * 3 / SFU_OPS_PER_S * 1e3}


def phase_kernel():
    import torch

    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray_fwd
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray_uw

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    cases = {
        "main": (np.array([1, 0, 0.3, 1, 0, 1, 1, 0], np.float32),
                 (8, 512, 512)),
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


def phase_profile(isp, det, images, nms, batch_ms):
    """Where one forced batch's device time goes: kernel time by name
    (torch.profiler), its share of the unprofiled batch time, and the
    detector forward against NMS (CUDA events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adaptiveisp_tpu_torch.detect.model import decode_predictions
    from adaptiveisp_tpu_torch.detect.nms import non_max_suppression

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = isp.process(images, pipeline=FORCED, seed=2)
        det.detect(out, **nms)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), reverse=True)
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
        launches = phase_serving()
    except Exception:  # any failed phase fails the run, with its traceback
        traceback.print_exc()
        return 1
    main_case = kern["main"]
    emit({"kernels": [{
        "name": "nlm_gray_fwd", "route": "cuda",
        "source": "adaptiveisp_tpu_torch/ops/cuda/csrc/nlm_fwd.cu",
        "replaces": "adaptiveisp_tpu/ops/pallas/nlm.py:72",
        "launches": launches["nlm_gray_fwd"],
        "max_abs_err": max(kern[c]["max_abs_err_out"] for c in kern),
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
