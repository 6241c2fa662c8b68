#!/usr/bin/env python
"""Streaming detection CLI (port of the root ``detect_cli.py``): detection,
optionally after the adaptive ISP, over images, video files, globs, webcam
indices or rtsp/http streams, printing and saving results.

    python -m adaptiveisp_tpu_torch.detect_cli --source DIR --device cuda \\
        [--weights W] [--isp_weights AGENT] [--save_txt] [--save_img] ...

``--isp_weights`` runs the agent's rollout on each letterboxed frame (K1
on the card whenever the agent picks denoise), ``--half`` the detector in
bf16 autocast, ``--augment`` test-time augmentation.  ``--device cuda``
(the default) raises without a GPU.
"""

import argparse
import os

from adaptiveisp_tpu_torch.config import Config


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--source", type=str, required=True,
                   help="image file/folder/.txt list/glob, video file, "
                        "webcam index, rtsp/http url, or .streams file")
    p.add_argument("--vid_stride", type=int, default=1,
                   help="video frame-rate stride")
    p.add_argument("--max_frames", type=int, default=None,
                   help="stop a live stream after N frames")
    p.add_argument("--weights", type=str, default="pretrained/yolov3.pt")
    p.add_argument("--isp_weights", type=str, default=None,
                   help="run adaptive ISP preprocessing with this agent ckpt")
    p.add_argument("--isp_steps", type=int, default=5)
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--conf_thres", type=float, default=0.25)
    p.add_argument("--iou_thres", type=float, default=0.45)
    p.add_argument("--max_det", type=int, default=300)
    p.add_argument("--save_dir", type=str, default="runs/detect")
    p.add_argument("--exist_ok", action="store_true",
                   help="write into --save_dir even if it exists "
                        "(default: auto-increment like increment_path)")
    p.add_argument("--save_txt", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="TTA inference (3 scales + lr flip)")
    p.add_argument("--classes", type=int, nargs="*", default=None,
                   help="filter detections by class id, e.g. --classes 0 2")
    p.add_argument("--agnostic_nms", action="store_true",
                   help="class-agnostic NMS")
    p.add_argument("--half", action="store_true",
                   help="bf16 detector inference (autocast)")
    p.add_argument("--save_img", action="store_true",
                   help="save annotated images")
    p.add_argument("--save_crop", action="store_true",
                   help="save per-detection crops")
    p.add_argument("--visualize", action="store_true",
                   help="dump per-stage feature-map grids")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.sources import open_source
    from adaptiveisp_tpu_torch.obs.logging import increment_path

    args = parse_args(argv)
    det = api.load_detector(
        weights=args.weights, device=args.device, augment=args.augment,
        dtype=torch.bfloat16 if args.half else None)
    isp = (api.load_adaptive_isp(args.isp_weights, cfg=Config(),
                                 steps=args.isp_steps, device=args.device)
           if args.isp_weights else None)
    args.save_dir = increment_path(args.save_dir, exist_ok=args.exist_ok)
    os.makedirs(args.save_dir, exist_ok=True)

    source = open_source(args.source, vid_stride=args.vid_stride,
                         max_frames=args.max_frames)
    for src in (source if isinstance(source, list) else [source]):
        _run_source(src, args, isp, det)
    return args.save_dir


def _run_source(source, args, isp, det):
    import torch

    from adaptiveisp_tpu_torch.api import Detections
    from adaptiveisp_tpu_torch.data.letterbox import letterbox
    from adaptiveisp_tpu_torch.detect.boxes import scale_boxes

    for name, raw, meta in source:
        h0, w0 = raw.shape[:2]
        img, ratio, pad = letterbox(raw, args.imgsz, color=(0, 0, 0))
        x = torch.from_numpy(img[None]).to(det.device)
        if isp is not None:
            x = isp.process(x)
        dets, nvalid = det.detect(
            x, conf_thres=args.conf_thres, iou_thres=args.iou_thres,
            max_det=args.max_det, multi_label=False,
            classes=args.classes or None, agnostic=args.agnostic_nms)
        d = dets[0][:int(nvalid[0])].cpu().numpy()
        if d.shape[0]:
            d[:, :4] = scale_boxes((args.imgsz, args.imgsz), d[:, :4],
                                   (h0, w0), (ratio, pad))
        print(f"{name}: {d.shape[0]} detections")
        for r in d:
            c = int(r[5])
            cls = det.names.get(c, r[5])
            print(f"  {cls} {r[4]:.2f} "
                  f"[{r[0]:.0f},{r[1]:.0f},{r[2]:.0f},{r[3]:.0f}]")
        safe = os.path.splitext(name.replace(":", "_"))[0]
        if args.save_txt:
            with open(os.path.join(args.save_dir, safe + ".txt"), "w") as f:
                for r in d:
                    f.write(" ".join(f"{v:.5g}" for v in r) + "\n")
        if args.save_img or args.save_crop:
            dd = Detections([raw], [d], det.names, paths=[safe + ".png"])
            if args.save_img:
                dd.save(args.save_dir)
            if args.save_crop:
                dd.crop(os.path.join(args.save_dir, "crops"))
        if args.visualize:
            from adaptiveisp_tpu_torch.obs.plots import (
                capture_features,
                feature_visualization,
            )

            feature_visualization(capture_features(det.model, x),
                                  os.path.join(args.save_dir, safe))


if __name__ == "__main__":
    main()
