"""Closed-loop adaptive inference: one client sends batches back to back,
each batch's upload, 5-step rollout (``AdaptiveISP.process``), YOLO forward
and NMS (``Detector.detect``) and the fetch of its detections to the host.

The traffic file gives the batch, the image size, the scene pool (pinned
host memory), the render, the NMS settings and how many batches are warmed
up, checked and traced.  Every batch of the window is timed from its
upload's start to its detections on the host.  A seeded sample of the
window's batches is checked afterwards against the plain reference.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import devices, precision
from benchmark.harness import Outcome, load_json, BENCH_DIR
from benchmark.reference import compare
from benchmark.reference import models as ref
from benchmark.roofline import devicetrace
from benchmark.traffic.scenes import make_scenes
from benchmark.weights import seed_of, shapes_of, spread_state


def limits_of(cell_name: str) -> Dict[str, float]:
    return load_json(BENCH_DIR / "limits" / f"{cell_name}.json")["limits"]


class Plan:
    """Which pool batch and which noise seed unit ``k`` takes: the pool's
    batches in a seeded order, a fresh order each pass."""

    def __init__(self, seed: int, n_batches: int):
        self.seed, self.n = seed, n_batches
        self.orders: Dict[int, np.ndarray] = {}

    def slot(self, k: int) -> int:
        epoch = k // self.n
        if epoch not in self.orders:
            rng = np.random.RandomState(
                seed_of(self.seed, f"order{epoch}") % 2 ** 32)
            self.orders[epoch] = rng.permutation(self.n)
        return int(self.orders[epoch][k % self.n])

    def noise_seed(self, k: int) -> int:
        return seed_of(self.seed, f"noise{k}") % 2 ** 32


def weights(cell, device):
    """The agent's and the detector's state dicts, drawn from the
    configuration's ``weights_seed``: one model for every run, as a
    deployment serves one checkpoint, so that the agent's choices and the
    detector's candidates, which set how much work a batch is, do not
    change with ``--seed``."""
    cfg_file = cell.config
    seed = int(cfg_file["weights_seed"])
    return (spread_state(shapes_of(ref.agent(cfg_file)),
                         seed_of(seed, "agent"), device),
            spread_state(shapes_of(ref.detector(cfg_file)),
                         seed_of(seed, "detector"), device))


def scene_pool(cell, seed: int, device) -> torch.Tensor:
    """The traffic's scenes in pinned host memory, [P, H, W, 3] float32."""
    tr = cell.traffic
    size = int(tr["imgsz"])
    scenes, _ = make_scenes(int(tr["pool_images"]), size, size,
                            seed_of(seed, "scenes"), device, tr["scene"])
    return devices.host_buffer(scenes, device)


def build_program(cell, agent_sd, det_sd, device):
    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.detect.spec import load_spec

    cfg_file = cell.config
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in cfg_file["agent_config"].items()})
    isp = api.load_adaptive_isp(cfg=cfg, steps=int(cfg.test_steps),
                                device=device, state_dict=agent_sd)
    det = api.load_detector(spec=load_spec(cfg_file["detector"]["spec"]),
                            device=device, state_dict=det_sd)
    return isp, det


def served_unit(isp, det, pool, plan, k: int, tr, device, spans=None):
    """One batch through the served path; returns (rollout result,
    detections and counts on the host).  ``spans`` (a dict of lists), when
    given, gets each stage's seconds, each ending in a synchronize."""
    b = int(tr["batch"])
    s = plan.slot(k)
    t0 = time.perf_counter()
    x = pool[s * b:(s + 1) * b].to(device, non_blocking=True)
    if spans is not None:
        devices.sync(device)
        t1 = time.perf_counter()
    res = isp.process_with_trace(x, seed=plan.noise_seed(k),
                                 record_steps=False)
    if spans is not None:
        devices.sync(device)
        t2 = time.perf_counter()
    dets, n_valid = det.detect(res.image, **tr["nms"])
    dets, n_valid = dets.cpu().numpy(), n_valid.cpu().numpy()
    if spans is not None:
        t3 = time.perf_counter()
        spans["upload"].append(t1 - t0)
        spans["rollout"].append(t2 - t1)
        spans["detect"].append(t3 - t2)
    return res, dets, n_valid


def check_units(seed: int, warm: int, tr) -> List[int]:
    """The window's batches whose outputs are checked, drawn from the seed
    among its first ``check_from_first``."""
    rng = np.random.RandomState(seed_of(seed, "check") % 2 ** 32)
    pick = rng.choice(int(tr["check_from_first"]), int(tr["check_units"]),
                      replace=False)
    return sorted(warm + int(i) for i in pick)


def reference_numbers(cell, seed: int, pool, plan, kept, device,
                      count_flops: bool = False):
    """Each checked batch's served outputs against the reference (f32,
    TF32 off); returns (the worst of each number, model FLOPs of one batch
    by dtype when ``count_flops``)."""
    cfg_file, tr = cell.config, cell.traffic
    agent_sd, det_sd = weights(cell, device)
    agent = ref.agent(cfg_file, agent_sd, device)
    detector = ref.detector(cfg_file, det_sd, device)
    del agent_sd, det_sd
    spec = ref.spec(cfg_file)
    steps, b = int(cfg_file["agent_config"]["test_steps"]), int(tr["batch"])
    readings, flops = [], None
    with precision.reference():
        for k, (sel, params, image, dets, n_valid) in kept.items():
            s = plan.slot(k)
            x = pool[s * b:(s + 1) * b].to(device)
            if count_flops and flops is None:
                flops = precision.count_flops(lambda: (
                    ref.detect(detector, ref.adaptive_rollout(
                        agent, x, steps, plan.noise_seed(k), tr["render"]
                    ).image, tr["nms"], spec)))
            res = ref.adaptive_rollout(agent, x, steps, plan.noise_seed(k),
                                       tr["render"])
            nums = compare.rollout_numbers(sel, params, image, res.selected,
                                           res.params, res.image)
            ref_dets, ref_n = ref.detect(detector, image.to(device),
                                         tr["nms"], spec)
            nums.update(compare.detection_numbers(
                dets, n_valid, ref_dets.cpu().numpy(), ref_n.cpu().numpy(),
                int(tr["nms"]["max_det"])))
            readings.append(nums)
    return compare.worst(readings), flops


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device) -> Outcome:
    tr = cell.traffic
    phases = devices.Phases(started)
    precision.program(cell.config["precision"]["infer"])
    agent_sd, det_sd = weights(cell, device)
    phases.mark("weights")
    isp, det = build_program(cell, agent_sd, det_sd, device)
    del agent_sd, det_sd
    phases.mark("program")
    pool = scene_pool(cell, seed, device)
    phases.mark("scenes")
    plan = Plan(seed, pool.shape[0] // int(tr["batch"]))
    gc.collect()
    devices.reset_peak(device)

    warm = int(tr["warmup_units"])
    for k in range(warm):
        served_unit(isp, det, pool, plan, k, tr, device)
    devices.sync(device)
    phases.mark("warmup")
    phases.report()

    to_check = set(check_units(seed, warm, tr))
    kept, latencies, spans = {}, [], None
    if trace:
        spans = {"upload": [], "rollout": [], "detect": []}
    images, failed, k = 0, 0, warm
    t_start = time.perf_counter()
    setup_s = t_start - started
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        res, dets, n_valid = served_unit(isp, det, pool, plan, k, tr,
                                         device, spans)
        latencies.append(time.perf_counter() - t0)
        b = dets.shape[0]
        images += b
        bad = ~np.isfinite(dets).all(axis=(1, 2)) | (n_valid < 0) | (
            n_valid > int(tr["nms"]["max_det"]))
        failed += int(bad.sum())
        if k in to_check:
            kept[k] = (res.selected, res.params, res.image, dets, n_valid)
        k += 1
    window_s = time.perf_counter() - t_start
    peak = devices.peak_bytes(device)
    units = k - warm

    layer, breakdown = {}, None
    dev_info = {"platform": "gpu", "kind": devices.name(device),
                "count": 1, "memory_peak_bytes": peak}
    if trace:
        layer, breakdown = traced_units(cell, isp, det, pool, plan, k,
                                        device)
        dev_info["busy_s"] = layer["trace"]["busy_s"]
        dev_info["window_s"] = layer["trace"]["window_s"]
        layer.update(spans=spans, units=units, window_s=window_s,
                     batch=int(tr["batch"]))
    del isp, det, res
    gc.collect()
    devices.free(device)

    numbers, flops = reference_numbers(cell, seed, pool, plan, kept, device,
                                       count_flops=trace)
    if trace:
        layer["flops_by_dtype"] = {
            cell.config["precision"]["infer"]["dtype"]: flops}
    print("reference numbers " + " ".join(
        f"{k}={v}" for k, v in numbers.items()), file=sys.stderr)
    checks = compare.to_checks(numbers, limits_of(cell.name))
    if len(kept) < len(to_check):
        checks.append(("checked_batches_missing",
                       float(len(to_check) - len(kept)), 0.0))
    e2e = {"infer_images_per_s": images / window_s,
           "infer_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
           "setup_s": setup_s}
    devices.spread_report("batch", latencies)
    return Outcome(e2e, images, failed, checks, dev_info, layer, breakdown)


def traced_units(cell, isp, det, pool, plan, k0: int, device):
    """``trace_units`` more batches under the profiler, after the window;
    returns what the per-layer readers read and the breakdown."""
    tr = cell.traffic
    n_units = int(tr["trace_units"])
    denoise = ref.filter_index(cell.config, "denoise")
    size, b = int(tr["imgsz"]), int(tr["batch"])
    with devicetrace.Recorder(cell.name) as rec:
        sels = []
        for k in range(k0, k0 + n_units):
            res, _, _ = served_unit(isp, det, pool, plan, k, tr, device)
            sels.append(res.selected)
    summary = rec.summary()
    nlm = []
    if denoise >= 0:
        for sel in sels:
            for row in sel.cpu().numpy():
                nlm.append((int((row == denoise).sum()), b, size, size))
    layer = {"trace": summary, "traced_images": n_units * b,
             "nlm_fwd_launches": nlm}
    return layer, devicetrace.breakdown(summary)
