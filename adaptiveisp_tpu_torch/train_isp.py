"""RL training CLI of the port (port of the root ``train_isp.py``).

    python -m adaptiveisp_tpu_torch.train_isp --task train_val \\
        --batch_size 8 --epochs 800 --data_cfg lod --save_path adaptiveisp
    python -m adaptiveisp_tpu_torch.train_isp --task val \\
        --model_weights experiments/lod-adaptiveisp/ckpt

Trains the agent on ``--device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions).  Outputs go under ``experiments/<data_name>-
<save_path>/`` of the working directory: logs, checkpoints
(``ckpt/<step>/state.pt``) and validation trajectories.  ``--task val``
renders the validation set at full resolution with the agent of
``--model_weights`` (``eval/hr_render.py``) under ``--val_save_path``.

``--dp N`` trains data parallel on N ranks (``train/mesh.py``): NCCL on N
cards, or gloo with ``--device cpu``; below 0 takes every card.  Run
alone, the CLI starts the ranks itself; under ``torchrun`` each rank joins
the group torchrun started.  Rank 0 writes the outputs.
``--task val --spatial_shard N`` spreads each full-resolution frame's rows
over N ranks the same way.
"""

from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", type=str, default="train_val",
                   help="train, train_val, val")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--weights", type=str, default="pretrained/yolov3.pt",
                   help="detector weights: an ultralytics .pt/.pth, or a "
                        ".pkl of flax variables (params, batch_stats)")
    p.add_argument("--hyp", type=str, default=None,
                   help="loss hyp YAML (defaults to scratch-low values)")
    p.add_argument("--yolo_spec", type=str, default=None,
                   help="reward-detector architecture: yolov3 (default) "
                        "or yolov3-tiny")
    p.add_argument("--save_path", type=str, default="adaptiveisp")
    p.add_argument("--data_name", type=str, default="lod",
                   choices=["lod", "coco", "rod", "oprd"])
    p.add_argument("--data_cfg", type=str, default=None,
                   help="dataset yaml / builtin name (default: data_name)")
    p.add_argument("--add_noise", action="store_true", default=False)
    p.add_argument("--use_linear", action="store_true", default=False)
    p.add_argument("--bri_range", type=float, default=None, nargs="*")
    p.add_argument("--noise_level", type=float, default=None)
    p.add_argument("--use_truncated", type=bool, default=True)
    p.add_argument("--runtime_penalty", action="store_true", default=False)
    p.add_argument("--runtime_penalty_lambda", type=float, default=0.01)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint directory to continue from")
    p.add_argument("--model_weights", type=str, default=None,
                   help="--task val: the agent's checkpoint directory or "
                        "weights-only file")
    p.add_argument("--val_save_path", type=str,
                   default="experiments/adaptiveisp-val")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--spatial_shard", type=int, default=1,
                   help="spread each full-res frame's rows over N ranks "
                        "during --task val (NCCL on N cards, gloo with "
                        "--device cpu)")
    p.add_argument("--cfg", type=str, default=None,
                   help="python module exporting `cfg` (a port Config), "
                        "e.g. adaptiveisp_tpu_torch.configs."
                        "config_fast_filters")
    p.add_argument("--max_steps", type=int, default=None,
                   help="cap training iterations (smoke runs); default = "
                        "epochs*1000/batch like the reference")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks: 0 off, N ranks (NCCL on N "
                        "cards, gloo with --device cpu), below 0 every card")
    p.add_argument("--device_replay", action="store_true", default=True,
                   help="keep the replay image pool on the device "
                        "(default)")
    p.add_argument("--no_device_replay", dest="device_replay",
                   action="store_false",
                   help="host-side replay pool (reference data flow)")
    p.add_argument("--no_cached_reward", action="store_true", default=False,
                   help="recompute the input-image detector loss every step "
                        "instead of reusing the slot's cached write-back "
                        "loss (same values; debug only)")
    p.add_argument("--yolo_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="compute dtype of the frozen reward detector")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    args.save_path = args.data_name + "-" + args.save_path
    if args.data_name == "lod":
        # reference coupling rule (train.py:652-655)
        args.add_noise = False
        args.bri_range = None
        args.use_linear = False
    return args


def load_yolo_weights(path, spec):
    """Detector ``state_dict`` for the port's ``DetectionModel``: an
    ultralytics ``.pt``/``.pth`` (``model.{i}.*`` keys) directly, a ``.pkl``
    of flax variables through ``convert.yolo_from_flax``; a missing file
    warns and returns None (seeded random weights).  A name that is not a
    file is looked up locally by ``data.artifacts.resolve_artifact``
    (never downloaded)."""
    if path and not os.path.isfile(path):
        from adaptiveisp_tpu_torch.data.artifacts import resolve_artifact

        try:
            path = resolve_artifact(path, download=False)
        except FileNotFoundError:
            pass
    if path and os.path.isfile(path):
        if path.endswith((".pkl", ".pickle")):
            import pickle

            from adaptiveisp_tpu_torch.convert import yolo_from_flax

            with open(path, "rb") as f:
                variables = pickle.load(f)
            return yolo_from_flax(variables["params"],
                                  variables["batch_stats"], spec)
        if path.endswith((".pt", ".pth")):
            import torch

            ckpt = torch.load(path, map_location="cpu", weights_only=False)
            model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) \
                else ckpt
            sd = (model.float().state_dict()
                  if hasattr(model, "state_dict") else model)
            return {k: v.float() if v.is_floating_point() else v
                    for k, v in sd.items()}
    print(f"[warn] detector weights '{path}' not found; using random init "
          f"(mAP-parity runs need the converted COCO checkpoint)",
          file=sys.stderr)
    return None


def main(argv=None):
    args = parse_args(argv)
    if args.task not in ("train", "train_val", "val"):
        raise SystemExit(f"unknown task {args.task}")
    from adaptiveisp_tpu_torch.train import mesh as mesh_lib

    if args.task != "val":
        mesh, launched = mesh_lib.cli_mesh(
            args.dp, args.device, "adaptiveisp_tpu_torch.train_isp:main",
            argv)
    else:
        mesh, launched = mesh_lib.cli_mesh(
            0, args.device, "adaptiveisp_tpu_torch.train_isp:main", argv,
            n_axis=args.spatial_shard if args.spatial_shard > 1 else 0,
            axis=mesh_lib.SPATIAL_AXIS)
    if launched:
        return None

    from adaptiveisp_tpu_torch.config import TrainConfig
    from adaptiveisp_tpu_torch.data.dataset_config import check_dataset
    from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC, resolve_spec
    from adaptiveisp_tpu_torch.render_isp import load_cfg
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    cfg = load_cfg(args.cfg)
    tcfg = TrainConfig(
        batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
        imgsz=args.imgsz, data_name=args.data_name,
        add_noise=args.add_noise, use_linear=args.use_linear,
        bri_range=tuple(args.bri_range) if args.bri_range else None,
        noise_level=args.noise_level, use_truncated=args.use_truncated,
        runtime_penalty=args.runtime_penalty,
        runtime_penalty_lambda=args.runtime_penalty_lambda)

    data = check_dataset(args.data_cfg or args.data_name)
    if args.task == "val":
        from adaptiveisp_tpu_torch.eval.hr_render import run_hr_validation

        return run_hr_validation(cfg, tcfg, data, args.model_weights,
                                 args.val_save_path, steps=args.steps,
                                 spatial_shard=args.spatial_shard,
                                 device=args.device, mesh=mesh)
    spec = resolve_spec(args.yolo_spec) if args.yolo_spec else YOLOV3_SPEC
    yolo_sd = load_yolo_weights(args.weights, spec)
    loss_hyp = None
    if args.hyp:
        from adaptiveisp_tpu_torch.detect.hyp import load_hyp, split_hyp

        _, loss_hyp, _ = split_hyp(load_hyp(args.hyp),
                                   nl=len(spec["anchors"]), nc=spec["nc"],
                                   imgsz=args.imgsz)

    trainer = Trainer(
        cfg, tcfg, data["train"],
        val_path=data.get("val") if args.task == "train_val" else None,
        save_dir=os.path.join("experiments", args.save_path),
        yolo_state_dict=yolo_sd, data_source=data.get("source"),
        device_replay=args.device_replay,
        cached_reward=not args.no_cached_reward,
        yolo_dtype=args.yolo_dtype, yolo_spec=spec, loss_hyp=loss_hyp,
        device=args.device, mesh=mesh)
    try:
        if args.resume:
            trainer.resume(args.resume)
        trainer.train(max_steps=args.max_steps)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
