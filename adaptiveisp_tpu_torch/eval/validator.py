"""Adaptive inference and detection evaluation (port of
``adaptiveisp_tpu/eval/validator.py``).

The agent-in-the-loop ISP on each validation image (a ``steps``-step
rollout), the frozen detector, NMS, IoU matching at 10 thresholds and
``ap_per_class``, with the reference's artifacts: ``records.txt`` (each
image's filter sequence), per-step images, one parameter JSON per batch,
label files, COCO JSON, plots, and the reference's speed report
(val_adaptiveisp.py:104-460).  The defaults are the reference's eval
protocol: 512 px, batch 1, 5 steps, conf 0.001, IoU 0.6, max_det 300,
multi-label NMS.

The host loop is double-buffered as the JAX package's: a producer thread
decodes and collates batches ahead into pinned host memory, batch k+1 is
uploaded (``non_blocking``) and its work queued on the device before
batch k's results are read, and each batch's detections, counts and
selections come back in one asynchronous copy.  The switch render reads
the selected filter id on the host once per step, and NMS reads its
block loop's stop condition; both wait for the device there.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from adaptiveisp_tpu_torch.data.datasets import ISPDataset, collate
from adaptiveisp_tpu_torch.data.prefetch import Prefetcher
from adaptiveisp_tpu_torch.detect.boxes import scale_boxes, xyxy2xywhn
from adaptiveisp_tpu_torch.detect.metrics import (
    ConfusionMatrix,
    process_batch,
    summarize,
)
from adaptiveisp_tpu_torch.detect.model import decode_predictions
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.detect.tta import forward_augment
from adaptiveisp_tpu_torch.eval import coco_json
from adaptiveisp_tpu_torch.eval.rollout import no_pipeline, rollout
from adaptiveisp_tpu_torch.obs.logging import save_img
from adaptiveisp_tpu_torch.obs.profile import Profile, speed_report
from adaptiveisp_tpu_torch.ops.bank import filter_specs, param_offsets
from adaptiveisp_tpu_torch.policy.states import get_initial_states, get_noise
from adaptiveisp_tpu_torch.parallel import all_gather, data_sharding


def _to_host(tensors, dev):
    """Start one asynchronous device-to-host copy of each tensor into
    pinned memory; returns (host tensors, the event after the copies).
    On the CPU the tensors are already on the host."""
    if dev.type != "cuda":
        return list(tensors), None
    out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t, non_blocking=True) for t in tensors]
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


@torch.no_grad()
def run_validation(cfg, agent, yolo, dataset: ISPDataset, steps: int = 5,
                   conf_thres: float = 0.001, iou_thres: float = 0.6,
                   max_det: int = 300, batch_size: int = 1,
                   pipeline: Optional[Sequence[int]] = None,
                   save_dir: Optional[str] = None,
                   save_image: bool = False, save_param: bool = False,
                   save_json: bool = False, anno_json: Optional[str] = None,
                   noise_seed: int = 0, max_images: int = -1,
                   render: str = "auto", yolo_spec=None, mesh=None,
                   class_names=None, profile: bool = False,
                   merge: bool = False, plots: bool = False,
                   augment: bool = False, save_txt: bool = False,
                   save_conf: bool = False, save_hybrid: bool = False,
                   single_cls: bool = False, max_labels: int = 128,
                   max_nms: int = 4096) -> Dict:
    """Returns {'precision', 'recall', 'map50', 'map', 'speed',
    'wall_ms_per_img', 'records', ...}.

    ``agent`` (the port's ``Agent``) and ``yolo`` (a ``DetectionModel``)
    carry their weights, in eval mode on the device the run uses; the JAX
    function's ``agent_variables`` and ``yolo_variables`` have no
    counterpart.  ``yolo_spec`` defaults to the detector's own.

    render="auto" is the switch render (only the selected filter) at batch
    1 or with a forced pipeline, where the whole batch shares one action,
    else the one-hot blend.  profile=True times the rollout with the
    detector ("inference") and NMS ("nms") apart, waiting for the card at
    each bucket's edges; otherwise "inference" holds all three and no
    bucket waits.

    mesh (a data mesh from ``parallel.make_mesh``, one call per rank):
    each rank runs its rows of every batch that divides over the ranks (a
    batch that does not runs whole on every rank, as in the JAX package);
    the detections, selections and recorded outputs are gathered, so
    every rank computes the single-device run's ``records`` and mAP.  Rank
    0 alone writes under ``save_dir``.
    """
    if mesh is not None and not hasattr(mesh, "rank"):
        raise TypeError("mesh= takes a data mesh from "
                        "parallel.make_mesh")
    if mesh is not None and not mesh.is_main:
        save_dir = None
    if render == "auto":
        render = ("switch" if batch_size == 1 or pipeline is not None
                  else "blend")
    dev = next(agent.parameters()).device
    spec = yolo_spec or yolo.spec
    iouv = np.linspace(0.5, 0.95, 10)
    names = [s.short_name for s in filter_specs(cfg)]
    rng = np.random.RandomState(noise_seed)
    pipe = (no_pipeline(steps) if pipeline is None
            else [-1 if p is None else int(p) for p in pipeline])
    det_nc = (yolo_spec["nc"] if yolo_spec is not None
              else (len(class_names) if class_names else 80))
    nms_kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                  max_det=max_det, max_nms=max_nms, multi_label=True,
                  merge=merge, agnostic=single_cls)

    def detect(image):
        if augment:  # TTA: three scaled/flipped passes (yolo.py:205-252)
            return forward_augment(yolo, image, spec)
        return decode_predictions(yolo(image), spec)

    def infer(im, noises, states, hyb):
        """(rollout result, predictions ready for NMS)."""
        res = rollout(agent, im, noises, states, pipe,
                      record_steps=save_image, render=render)
        preds = detect(res.image)
        if hyb is not None:
            # autolabelling: ground-truth rows ride along as conf-1.0 NMS
            # candidates (reference val.py:218-219 labels= path)
            preds = torch.cat([preds, hyb], dim=1)
        return res, preds

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        if save_image:
            for i in range(steps):
                os.makedirs(os.path.join(save_dir, "img_results",
                                         f"step-{i}"), exist_ok=True)
        if save_param:
            os.makedirs(os.path.join(save_dir, "param_results"),
                        exist_ok=True)

    profiles = {"pre": Profile(), "inference": Profile(sync=profile),
                "nms": Profile(sync=profile), "post": Profile()}
    stats, records, coco_records = [], [], []
    confusion = ConfusionMatrix(nc=det_nc) if plots else None
    n_total = len(dataset) if max_images < 0 else min(max_images, len(dataset))

    if n_total and dev.type == "cuda":
        # warm the card (cuDNN plans, kernel loads) so the speed report
        # measures steady state; its noise stream is not the run's
        wb = collate([dataset[0]] * batch_size)
        wno = np.stack([get_noise(np.random.RandomState(0), batch_size,
                                  cfg.z_dim, cfg.z_type)
                        for _ in range(steps)])
        whyb = (torch.zeros((batch_size, max_labels, 5 + det_nc),
                            device=dev) if save_hybrid else None)
        _, wpred = infer(torch.from_numpy(wb["im"]).to(dev),
                         torch.from_numpy(wno).to(dev),
                         torch.from_numpy(get_initial_states(
                             batch_size, cfg.num_state_dim)).to(dev), whyb)
        non_max_suppression(wpred, **nms_kw)
        torch.cuda.synchronize(dev)

    def host_prep(idx):
        """Decode, collate and draw the noise (on the producer thread)."""
        batch = collate([dataset[i] for i in idx])
        nb = batch["im"].shape[0]
        noises = np.stack([get_noise(rng, nb, cfg.z_dim, cfg.z_type)
                           for _ in range(steps)])
        arrays = [batch["im"], noises,
                  get_initial_states(nb, cfg.num_state_dim)]
        if save_hybrid:
            # padded [nb, L, 5+nc] GT candidate rows: xywh px, obj 1.0,
            # one-hot class (reference val.py:218-219)
            hgt, wdt = batch["im"].shape[1:3]
            hyb = np.zeros((nb, max_labels, 5 + det_nc), np.float32)
            for bi in range(nb):
                lab = batch["label"][bi]
                n = min(lab.shape[0], max_labels)
                if n:
                    hyb[bi, :n, 0:4] = lab[:n, 2:6] * np.array(
                        [wdt, hgt, wdt, hgt], np.float32)
                    hyb[bi, :n, 4] = 1.0
                    cls = (np.zeros(n, int) if single_cls
                           else lab[:n, 1].astype(int))
                    hyb[bi, np.arange(n), 5 + cls] = 1.0
            arrays.append(hyb)
        tensors = [torch.from_numpy(a) for a in arrays]
        if dev.type == "cuda":
            tensors = [t.pin_memory() for t in tensors]
        return batch, tensors

    def dispatch(prepped):
        """Upload and queue one batch's device work; no host read but the
        rollout's and NMS's own."""
        batch, tensors = prepped
        nb = tensors[0].shape[0]
        sharded = (mesh is not None and mesh.data_size > 1
                   and nb % mesh.data_size == 0)
        if sharded:
            # the rank's rows (the noise is [steps, batch, z])
            rows = data_sharding(mesh, nb)
            tensors = [t[:, rows] if i == 1 else t[rows]
                       for i, t in enumerate(tensors)]
        with profiles["pre"]:
            im, noises, states, *hyb = [t.to(dev, non_blocking=True)
                                        for t in tensors]
        hyb = hyb[0] if hyb else None
        if profile:
            with profiles["inference"]:
                res, preds = infer(im, noises, states, hyb)
            with profiles["nms"]:
                dets, nvalid = non_max_suppression(preds, **nms_kw)
        else:
            with profiles["inference"]:
                res, preds = infer(im, noises, states, hyb)
                dets, nvalid = non_max_suppression(preds, **nms_kw)
        # one asynchronous copy of everything the host reads, so it
        # overlaps the next batch's device work
        fetch = [dets, nvalid, res.selected]
        if save_image:
            fetch.append(res.images_per_step)
        if save_param:
            fetch.append(res.params)
        if sharded:
            # batch-major gathers; the per-step outputs are [steps, batch]
            fetch = [all_gather(mesh, t) if i < 2 else
                     all_gather(mesh, t.transpose(0, 1).contiguous())
                     .transpose(0, 1) for i, t in enumerate(fetch)]
        return batch, im.shape[1:3], _to_host(fetch, dev)

    def consume(work):
        batch, (h, w), (host, ev) = work
        with profiles["post"]:
            if ev is not None:
                ev.synchronize()
            dets, nvalid, sels, *extra = [t.numpy() for t in host]
        per_step = extra.pop(0) if save_image else None
        params = extra.pop(0) if save_param else None
        postprocess(batch, h, w, dets, nvalid, sels, per_step, params)

    def postprocess(batch, h, w, dets, nvalid, sels, per_step, all_params):
        for bi in range(len(batch["path"])):
            path = batch["path"][bi]
            fname = os.path.split(path)[1]
            stem = os.path.splitext(fname)[0]
            (h0, w0), ((rh, rw), pad) = batch["shape"][bi]
            seq = [int(sels[s, bi]) for s in range(steps)]
            records.append((fname, seq))

            if save_dir and save_image:
                for s in range(steps):
                    save_img(per_step[s, bi], os.path.join(
                        save_dir, "img_results", f"step-{s}",
                        fname + ".png"))
            if save_dir and save_param and bi == 0:
                # one JSON per BATCH keyed by its first image, as the
                # reference (val_adaptiveisp.py:301, 324-327; the protocol
                # runs batch 1, where per batch is per image)
                offsets = param_offsets(cfg)
                param_doc = collections.OrderedDict()
                param_doc["pipeline"] = [s for s in seq if s >= 0]
                for s, fid in enumerate(seq):
                    if fid < 0:
                        continue
                    lo, hi = offsets[fid]
                    param_doc[f"step{s}_{names[fid]}"] = [
                        float(v) for v in all_params[s, bi, lo:hi]]
                with open(os.path.join(save_dir, "param_results",
                                       stem + ".json"), "w") as f:
                    json.dump(param_doc, f, indent=4)

            det = dets[bi][:int(nvalid[bi])].copy()
            lab = batch["label"][bi][:, 1:].copy()  # [n, 5] (cls, xywhn)
            if single_cls:
                # single-class evaluation (reference val.py:245)
                det[:, 5] = 0.0
                if lab.size:
                    lab[:, 0] = 0.0
            if lab.size:
                xywh = lab[:, 1:5] * np.array([w, h, w, h], np.float32)
                lab[:, 1:5] = np.concatenate(
                    [xywh[:, :2] - xywh[:, 2:] / 2,
                     xywh[:, :2] + xywh[:, 2:] / 2], axis=1)
            if det.shape[0]:
                det[:, :4] = scale_boxes((h, w), det[:, :4], (h0, w0),
                                         ((rh, rw), pad))
            if save_dir and save_txt:
                # normalized `cls xc yc w h [conf]` label files
                # (reference val.py save_one_txt, :50-56)
                os.makedirs(os.path.join(save_dir, "labels"), exist_ok=True)
                xywhn = xyxy2xywhn(det[:, :4], w=w0, h=h0)
                lines = []
                for ri in range(det.shape[0]):
                    vals = [int(det[ri, 5])] + xywhn[ri].tolist() + (
                        [float(det[ri, 4])] if save_conf else [])
                    lines.append(" ".join(f"{v:g}" for v in vals))
                with open(os.path.join(save_dir, "labels", stem + ".txt"),
                          "w") as f:
                    f.write("\n".join(lines) + ("\n" if lines else ""))
            if lab.size:
                lab_px = lab.copy()
                lab_px[:, 1:5] = scale_boxes((h, w), lab[:, 1:5], (h0, w0),
                                             ((rh, rw), pad))
            else:
                lab_px = np.zeros((0, 5), np.float32)
            correct = process_batch(det, lab_px, iouv)
            stats.append((correct, det[:, 4], det[:, 5], lab_px[:, 0]))
            if confusion is not None:
                confusion.process_batch(det, lab_px)
            if save_json:
                coco_records.extend(coco_json.detections_to_coco(
                    path, det, class_map=coco_json.COCO80_TO_91))

    # double-buffered drive: batch k+1 is dispatched before batch k is
    # fetched, so host post-processing and IO overlap device work
    t_wall0 = time.perf_counter()
    batches = iter([list(range(s, min(s + batch_size, n_total)))
                    for s in range(0, n_total, batch_size)])

    def produce():
        idx = next(batches, None)
        return None if idx is None else host_prep(idx)

    feeder = Prefetcher(produce, depth=2)
    try:
        pending = None
        while (prepped := feeder.get_next()) is not None:
            work = dispatch(prepped)
            if pending is not None:
                consume(pending)
            pending = work
        if pending is not None:
            consume(pending)
    finally:
        feeder.stop()
    wall_s = time.perf_counter() - t_wall0

    plot_dir = save_dir if (plots and save_dir) else None
    result = summarize(stats, names=class_names, plot_dir=plot_dir)
    if confusion is not None:
        result["confusion_matrix"] = confusion.matrix
        if plot_dir:
            cm_names = (list(class_names.values())
                        if isinstance(class_names, dict)
                        else list(class_names or ()))
            confusion.plot(save_dir=plot_dir, names=cm_names)
    result["speed"] = speed_report(profiles, n_total)
    result["wall_ms_per_img"] = 1000.0 * wall_s / max(n_total, 1)
    result["records"] = records
    if save_dir:
        with open(os.path.join(save_dir, "records.txt"), "w") as f:
            f.write(",".join(names) + "\n")
            for fname, seq in records:
                f.write(fname + "," + ",".join(str(s) for s in seq) + "\n")
        if save_json:
            pred_json = coco_json.save_predictions(coco_records, save_dir)
            if anno_json:
                rescored = coco_json.pycocotools_eval(pred_json, anno_json)
                if rescored:
                    result["coco_map"] = rescored["map"]
                    result["coco_map50"] = rescored["map50"]
    return result
