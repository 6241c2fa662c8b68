"""Export CLI of the port (counterpart of the root ``export_cli.py``, the
reference's ``yolov3/export.py`` entry point)::

    python -m adaptiveisp_tpu_torch.export_cli --model detector \\
        --weights yolov3.pt --include pt2 variables --validate

Formats:

- ``pt2``: a ``torch.export`` program (``detect/export.py``), in the place
  of JAX's ``stablehlo``.  The gated NLM is one registered operator in it:
  loaded after importing the port (``detect.export.load_program``), it
  launches the hand-written kernel on the card and runs the plain version
  on the CPU.
- ``variables``: the ``state_dict`` through ``torch.save`` (the keys the
  JAX package's converters read).
- ``saved_model``, ``pb``, ``tflite`` (``--half`` fp16, ``--int8``): the
  port has no PyTorch -> TensorFlow converter (``detect/export_tf.py``), so
  they are warned about and skipped, as JAX's CLI skips them without
  TensorFlow.

Each requested format is exported on its own and a success table is printed
at the end; ``--validate`` runs every artifact and prints max |d| against
the eager forward.  Runs on ``cuda`` unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

FORMATS = ("pt2", "variables", "saved_model", "pb", "tflite",
           "tflite-fp16", "tflite-int8")
NATIVE = ("pt2", "variables")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", type=str, default="detector",
                   choices=("detector", "adaptive_isp"),
                   help="what to export: the detector forward+decode, or "
                        "the full agent rollout graph")
    p.add_argument("--spec", type=str, default="yolov3",
                   help="yolov3 | yolov3-tiny | yolov5s | path to spec YAML")
    p.add_argument("--weights", type=str, default=None,
                   help="detector weights (.pt, or the JAX package's .pkl)")
    p.add_argument("--isp_weights", type=str, default=None,
                   help="agent checkpoint for --model adaptive_isp")
    p.add_argument("--cfg", type=str, default=None,
                   help="config module for --model adaptive_isp")
    p.add_argument("--imgsz", type=int, default=512)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=5,
                   help="rollout steps for --model adaptive_isp")
    p.add_argument("--include", type=str, nargs="+", default=["pt2"],
                   choices=FORMATS, help="formats to export")
    p.add_argument("--half", action="store_true",
                   help="alias: adds tflite-fp16 (reference --half)")
    p.add_argument("--int8", action="store_true",
                   help="alias: adds tflite-int8 (reference --int8)")
    p.add_argument("--calib_images", type=str, default=None,
                   help="images for int8 calibration (TFLite only, which "
                        "the port skips)")
    p.add_argument("--validate", action="store_true",
                   help="run each artifact and compare with the eager "
                        "output")
    p.add_argument("--out", type=str, default="runs/export/exp")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    return p.parse_args(argv)


def build_export(args):
    """(module, export(path), example_args, eager(*args) -> first output)
    for the chosen model, on the chosen device.  The example arguments are
    seeded images in [0, 1) (and normal noises): ``--validate`` runs them
    (an all-zero frame is not finite through every filter)."""
    import torch

    from adaptiveisp_tpu_torch import api
    from adaptiveisp_tpu_torch.detect import export as ex

    device = "cpu" if args.cpu else "cuda"
    if args.model == "detector":
        from adaptiveisp_tpu_torch.detect.model import decode_predictions
        from adaptiveisp_tpu_torch.detect.spec import resolve_spec

        spec = resolve_spec(args.spec)
        model = api.load_detector(weights=args.weights, spec=spec,
                                  device=device).model
        gen = torch.Generator().manual_seed(0)
        x = torch.rand((args.batch, args.imgsz, args.imgsz, 3),
                       generator=gen).to(next(model.parameters()).device)
        return (model,
                lambda path: ex.export_detector(model, path, args.imgsz,
                                                args.batch, spec),
                (x,), lambda im: decode_predictions(model(im), spec))

    from adaptiveisp_tpu_torch.eval.rollout import no_pipeline, rollout
    from adaptiveisp_tpu_torch.render_isp import load_cfg

    cfg = load_cfg(args.cfg)
    isp = api.load_adaptive_isp(args.isp_weights, cfg, args.imgsz,
                                args.steps, device=device)
    agent = isp.agent
    gen = torch.Generator().manual_seed(0)
    example = tuple(t.to(isp.device) for t in (
        torch.rand((args.batch, args.imgsz, args.imgsz, 3), generator=gen),
        torch.randn((args.steps, args.batch, cfg.z_dim), generator=gen),
        torch.zeros((args.batch, cfg.num_state_dim))))
    return (agent,
            lambda path: ex.export_adaptive_isp(cfg, agent, path, args.imgsz,
                                                args.steps, args.batch),
            example, lambda *a: rollout(agent, *a,
                                        no_pipeline(args.steps)).image)


def export_one(fmt, module, export, args) -> str:
    """Export one format; returns the artifact's path."""
    from adaptiveisp_tpu_torch.detect import export as ex

    if fmt == "pt2":
        return export(os.path.join(args.out, f"{args.model}.pt2"))
    if fmt == "variables":
        return ex.save_variables(
            module, os.path.join(args.out, f"{args.model}.vars.pt"))
    raise ValueError(f"unknown format {fmt!r}")


def validate_one(fmt, path, want, example_args):
    """Run the artifact; max |delta| against the eager output (None: no
    runner for this format)."""
    if fmt != "pt2":
        return None
    import torch

    from adaptiveisp_tpu_torch.detect.export import load_program

    with torch.no_grad():
        got = load_program(path).module()(*example_args)
    got = got[0] if isinstance(got, (tuple, list)) else got
    # NaN where the eager output has NaN counts as equal; elsewhere as inf
    both_nan = torch.isnan(got) & torch.isnan(want)
    d = (got - want).abs().nan_to_num(nan=float("inf"))
    return float(torch.where(both_nan, 0.0, d).max())


def main(argv=None):
    args = parse_args(argv)
    include = list(dict.fromkeys(
        args.include
        + (["tflite-fp16"] if args.half else [])
        + (["tflite-int8"] if args.int8 else [])))
    skipped = [f for f in include if f not in NATIVE]
    if skipped:
        print(f"[warn] no PyTorch -> TensorFlow converter is installed "
              f"(detect/export_tf.py); skipping {skipped}")
        include = [f for f in include if f in NATIVE]

    os.makedirs(args.out, exist_ok=True)
    module, export, example_args, eager = build_export(args)
    want = None
    if args.validate:
        import torch

        with torch.no_grad():
            want = eager(*example_args)

    rows, ok_all = [], True
    for fmt in include:
        t0 = time.perf_counter()
        try:
            path = export_one(fmt, module, export, args)
            dt = time.perf_counter() - t0
            size = os.path.getsize(path)
            delta = (validate_one(fmt, path, want, example_args)
                     if args.validate else None)
            note = "" if delta is None else f"max|d|={delta:.2e}"
            rows.append((fmt, "ok", path, f"{size/1e6:.1f} MB",
                         f"{dt:.1f}s", note))
        except Exception as e:  # per-format isolation, like the reference
            ok_all = False
            rows.append((fmt, "FAIL", "-", "-", "-",
                         f"{type(e).__name__}: {e}"))
    width = max((len(r[0]) for r in rows), default=0) + 2
    for r in rows:
        print(f"{r[0]:<{width}s}{r[1]:<6s}{r[3]:>10s}{r[4]:>8s}  "
              f"{r[2]}  {r[5]}")
    print("export complete" if ok_all else "export had failures")
    return 0 if ok_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
