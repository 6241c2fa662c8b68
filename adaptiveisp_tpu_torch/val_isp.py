"""Adaptive inference and mAP evaluation CLI of the port (port of the root
``val_isp.py``).

    python -m adaptiveisp_tpu_torch.val_isp --data lod.yaml \\
        --weights yolov3.pt --isp_weights experiments/lod-adaptiveisp/ckpt

Runs the agent-in-the-loop ISP on the validation set, the frozen YOLOv3,
NMS, and reports P/R/mAP50/mAP, the speed report and each image's filter
sequence, on ``--device`` (``cuda`` by default).  ``--isp_weights`` takes
the port's checkpoint directory or weights-only file, or the JAX package's
weights-only pickle.  Outputs go under ``--project/--name``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default="lod",
                   help="dataset yaml / builtin name")
    p.add_argument("--weights", type=str, default="pretrained/yolov3.pt",
                   help="detector weights: an ultralytics .pt/.pth, or a "
                        ".pkl of flax variables (params, batch_stats)")
    p.add_argument("--isp_weights", type=str, default=None,
                   help="agent weights: the port's checkpoint directory or "
                        "weights-only .pt, or the JAX package's weights-only "
                        ".pkl")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--conf_thres", type=float, default=0.001)
    p.add_argument("--iou_thres", type=float, default=0.6)
    p.add_argument("--max_det", type=int, default=300)
    p.add_argument("--max_nms", type=int, default=4096,
                   help="candidate cap before suppression; 30000 = the "
                        "reference's strict-parity value (slower)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--pipeline", type=int, nargs="*", default=None,
                   help="fixed filter-id sequence overriding the agent")
    p.add_argument("--save_image", action="store_true")
    p.add_argument("--save_param", action="store_true")
    p.add_argument("--max_images", type=int, default=-1)
    p.add_argument("--project", type=str, default="runs/val-adaptiveisp")
    p.add_argument("--name", type=str, default="exp")
    p.add_argument("--cfg", type=str, default=None,
                   help="python module exporting `cfg` (a port Config)")
    p.add_argument("--profile", action="store_true", default=False,
                   help="per-bucket timing that waits for the card at each "
                        "bucket's edges, instead of the pipelined loop")
    p.add_argument("--merge", action="store_true", default=False,
                   help="merge-NMS (weighted-box fusion, general.py:951)")
    p.add_argument("--augment", action="store_true", default=False,
                   help="TTA inference (3 scales + lr flip, yolo.py:211)")
    p.add_argument("--plots", action="store_true", default=False,
                   help="confusion matrix + PR/F1/P/R curve plots")
    p.add_argument("--save_json", action="store_true", default=False)
    p.add_argument("--anno_json", type=str, default=None,
                   help="COCO annotations for pycocotools rescoring")
    p.add_argument("--save_txt", action="store_true", default=False,
                   help="per-image normalized label txt files (val.py:50)")
    p.add_argument("--save_conf", action="store_true", default=False,
                   help="append confidences to --save_txt labels")
    p.add_argument("--save_hybrid", action="store_true", default=False,
                   help="label+prediction hybrid results (autolabelling; "
                        "GT rides as conf-1.0 NMS candidates, val.py:218)")
    p.add_argument("--single_cls", action="store_true", default=False,
                   help="treat as a single-class dataset (agnostic NMS)")
    p.add_argument("--half", action="store_true", default=False,
                   help="bf16 detector inference (autocast; parameters "
                        "stay f32)")
    p.add_argument("--task", type=str, default="val",
                   choices=["val", "test", "speed", "study"],
                   help="val/test = normal eval; speed = latency protocol "
                        "(conf 0.25, IoU 0.45); study = imgsz sweep + "
                        "speed-vs-mAP curve (reference val.py:388-406)")
    p.add_argument("--study_sizes", type=int, nargs="*", default=None,
                   help="image sizes for --task study (default "
                        "256..1536 step 128, the reference sweep)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def run_at_size(args, imgsz):
    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.data.datasets import ISPDataset
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
    from adaptiveisp_tpu_torch.eval.validator import run_validation
    from adaptiveisp_tpu_torch.render_isp import load_cfg
    from adaptiveisp_tpu_torch.train.checkpoint import load_agent_weights
    from adaptiveisp_tpu_torch.train_isp import load_yolo_weights

    cfg = load_cfg(args.cfg)
    data = check_dataset(args.data)
    ds = ISPDataset(data["val"], img_size=imgsz,
                    source=data.get("source", "normalize"), train=False)
    isp = api.load_adaptive_isp(
        cfg=cfg, seed=0, device=args.device,
        state_dict=(load_agent_weights(args.isp_weights, cfg)
                    if args.isp_weights else None))
    det = api.load_detector(
        spec=YOLOV3_SPEC, seed=1, device=args.device,
        state_dict=load_yolo_weights(args.weights, YOLOV3_SPEC),
        dtype=torch.bfloat16 if args.half else None)

    res = run_validation(
        cfg, isp.agent, det.model, ds,
        class_names=data.get("names"),
        steps=args.steps, conf_thres=args.conf_thres,
        iou_thres=args.iou_thres, max_det=args.max_det,
        batch_size=args.batch_size, pipeline=args.pipeline,
        save_dir=os.path.join(args.project, args.name),
        save_image=args.save_image, save_param=args.save_param,
        max_images=args.max_images, profile=args.profile,
        save_json=args.save_json, anno_json=args.anno_json,
        merge=args.merge, plots=args.plots, augment=args.augment,
        save_txt=args.save_txt, save_conf=args.save_conf,
        save_hybrid=args.save_hybrid, single_cls=args.single_cls,
        max_nms=args.max_nms)
    print(f"{'Class':>22s}{'P':>11s}{'R':>11s}{'mAP50':>11s}{'mAP50-95':>11s}")
    print(f"{'all':>22s}{res['precision']:11.3g}{res['recall']:11.3g}"
          f"{res['map50']:11.3g}{res['map']:11.3g}")
    for row in res.get("per_class", []):
        print(f"{row['class']:>22s}{row['precision']:11.3g}"
              f"{row['recall']:11.3g}{row['map50']:11.3g}{row['map']:11.3g}")
    print(res["speed"])
    print(f"wall: {res['wall_ms_per_img']:.1f} ms/img")
    return res


def main(argv=None):
    args = parse_args(argv)
    args.save_txt |= args.save_hybrid  # reference val.py:370
    if args.save_hybrid:
        print("WARNING: --save_hybrid returns high mAP from hybrid labels, "
              "not from predictions alone")

    if args.task == "speed":
        # latency protocol (reference val.py:389-393)
        args.conf_thres, args.iou_thres = 0.25, 0.45
        args.save_json = False
        args.plots = False
        return run_at_size(args, args.imgsz)

    if args.task == "study":
        # imgsz sweep -> study_{data}_{weights}.txt + speed-vs-mAP plot
        # (reference val.py:395-406)
        import numpy as np

        from adaptiveisp_tpu_torch.obs.plots import plot_val_study

        sizes = args.study_sizes or list(range(256, 1536 + 128, 128))
        rows = []
        for sz in sizes:
            print(f"\n--task study  imgsz={sz}")
            r = run_at_size(args, sz)
            t = r["wall_ms_per_img"]
            rows.append([r["precision"], r["recall"], r["map50"], r["map"],
                         0.0, t, 0.0, t])
        stem_d = os.path.splitext(os.path.basename(str(args.data)))[0]
        stem_w = os.path.splitext(os.path.basename(str(args.weights)))[0]
        out_dir = os.path.join(args.project, args.name)
        os.makedirs(out_dir, exist_ok=True)
        fname = os.path.join(out_dir, f"study_{stem_d}_{stem_w}.txt")
        np.savetxt(fname, np.asarray(rows, np.float64), fmt="%10.4g")
        plot_val_study(out_dir)
        print(f"study saved to {fname}")
        return rows

    return run_at_size(args, args.imgsz)


if __name__ == "__main__":
    main()
