"""Scripted-ISP batch renderer: apply a fixed filter chain to a stream (port
of the root ``render_isp.py``, single device).

Sources are a directory, glob, .txt list, video file, webcam id or stream
URL; outputs are rendered frames plus a throughput report.  On the card
``ops.bank.render_pipeline`` runs each maximal fusable run of the chain as
one launch of the K4 kernel, and each ``denoise`` stage as K1; with
``--device cpu`` the chain runs stage by stage in plain PyTorch.

Stages are given as repeatable ``--stage name:p1,p2,...`` flags or a YAML
script (a list of ``{name: ..., params: [...]}``), validated against each
filter's parameter count.  Parameters are the filters' squashed values, as
``render_fixed`` takes them.

    python -m adaptiveisp_tpu_torch.render_isp --source imgs/ \\
        --out runs/render --stage exposure:0.35 --stage gamma:0.1 \\
        --stage sharpen:0.8
"""

from __future__ import annotations

import argparse
import importlib
import os
import time

import numpy as np
import torch


def parse_stage(cfg, text: str):
    """``name:p1,p2,...`` -> (name, np.ndarray[P]); loud on bad counts."""
    from adaptiveisp_tpu_torch.ops.bank import get_spec

    name, _, rest = text.partition(":")
    spec = get_spec(cfg, name)  # KeyError on unknown filter names
    params = ([float(v) for v in rest.split(",") if v.strip() != ""]
              if rest else [])
    if len(params) != spec.n_params:
        raise ValueError(
            f"filter {name!r} takes {spec.n_params} parameter(s), "
            f"got {len(params)} in {text!r}")
    return name, np.asarray(params, np.float32)


def load_script(cfg, path: str):
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    if not isinstance(doc, list):
        raise ValueError(f"{path}: expected a YAML list of stages")
    stages = []
    for entry in doc:
        params = entry.get("params", [])
        text = entry["name"] + (":" + ",".join(str(p) for p in params)
                                if params else "")
        stages.append(parse_stage(cfg, text))
    return stages


def load_cfg(name):
    """The port ``Config`` named by a module (its ``cfg``), or the default."""
    from adaptiveisp_tpu_torch.config import DEFAULT_CONFIG, Config

    if not name:
        return DEFAULT_CONFIG
    cfg = getattr(importlib.import_module(name), "cfg", None)
    if not isinstance(cfg, Config):
        raise TypeError(
            f"--cfg {name}: its `cfg` must be an "
            f"adaptiveisp_tpu_torch.config.Config, got {type(cfg).__name__}")
    return cfg


def make_single_render(cfg, names, param_rows, device):
    """[n, H, W, 3] -> [n, H, W, 3] through the chain, with the stage
    parameters held on ``device``."""
    from adaptiveisp_tpu_torch.ops.bank import render_pipeline

    consts = [torch.as_tensor(p, dtype=torch.float32, device=device)
              for p in param_rows]

    @torch.no_grad()
    def fn(imgs):
        n = imgs.shape[0]
        stages = [(name, p[None].expand(n, p.shape[0]))
                  for name, p in zip(names, consts)]
        return render_pipeline(cfg, imgs, stages)

    return fn


def iter_groups(frames_iter, group: int):
    """Yield (names, [H,W,3] arrays) groups of consecutive same-shape
    frames; a shape change flushes the open group."""
    names, imgs, shape = [], [], None
    for name, img, _meta in frames_iter:
        if shape is not None and (img.shape != shape or len(imgs) == group):
            yield names, imgs
            names, imgs = [], []
        shape = img.shape
        names.append(name)
        imgs.append(img)
    if imgs:
        yield names, imgs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--source", required=True,
                   help="images dir/glob/.txt, video file, webcam id, url")
    p.add_argument("--out", default="runs/render",
                   help="output directory for rendered frames")
    p.add_argument("--stage", action="append", default=[],
                   metavar="NAME:P1,P2,...",
                   help="pipeline stage (repeatable, applied in order)")
    p.add_argument("--script", default=None,
                   help="YAML stage list (alternative to --stage)")
    p.add_argument("--batch", type=int, default=1,
                   help="frames per dispatch")
    p.add_argument("--vid_stride", type=int, default=1)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--cfg", type=str, default=None,
                   help="module whose `cfg` is an adaptiveisp_tpu_torch "
                        "Config")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain chain)")
    p.add_argument("--exist-ok", action="store_true")
    args = p.parse_args(argv)

    from adaptiveisp_tpu_torch.api import resolve_device
    from adaptiveisp_tpu_torch.data.sources import open_source
    from adaptiveisp_tpu_torch.obs.logging import increment_path, save_img

    device = resolve_device(args.device)
    cfg = load_cfg(args.cfg)
    stages = list(load_script(cfg, args.script)) if args.script else []
    stages += [parse_stage(cfg, s) for s in args.stage]
    if not stages:
        p.error("no pipeline: give --stage and/or --script")
    names = [n for n, _ in stages]
    render = make_single_render(cfg, names, [r for _, r in stages], device)

    out_dir = increment_path(args.out, exist_ok=args.exist_ok)
    os.makedirs(out_dir, exist_ok=True)
    src = open_source(args.source, vid_stride=args.vid_stride,
                      max_frames=args.max_frames)
    sources = src if isinstance(src, list) else [src]

    n_frames, n_pix, t0 = 0, 0, time.perf_counter()
    for source in sources:
        for fnames, imgs in iter_groups(iter(source), args.batch):
            batch = torch.from_numpy(np.stack(imgs).astype(np.float32))
            out = render(batch.to(device)).cpu().numpy()
            for fname, frame in zip(fnames, out):
                safe = fname.replace(":", "_").replace("/", "_")
                if not os.path.splitext(safe)[1]:
                    safe += ".png"
                save_img(frame, os.path.join(out_dir, safe))
            n_frames += len(fnames)
            n_pix += batch[..., 0].numel()
    wall = time.perf_counter() - t0
    chain = " -> ".join(names)
    print(f"rendered {n_frames} frame(s) through [{chain}] on {device} "
          f"in {wall:.2f}s ({n_pix / max(wall, 1e-9) / 1e6:.2f} MPix/s, "
          f"wall incl. IO) -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
