#!/usr/bin/env python3
"""Time the port's fused render kernel (K4) against other builds of a K4
source, in turns, on one GPU.

    python3 tools/pipeline_kernel_turns.py [--packed OLD.cu] [OTHER.cu ...]

Each source is built with K4's flags into ``build/turns/`` (one ``nvcc``
per source, all at once).  ``--packed`` names a source with the earlier C
entry, which took every stage's parameters as one packed [N, P] tensor
(``pack_params``) instead of a pointer and stride per stage, as the
kernel before the redesign with float4 accesses and persistent blocks
does (``git show <commit>:adaptiveisp_tpu_torch/ops/cuda/csrc/
pipeline_fwd.cu > old.cu``).  On the three timed cases of
``chip_smoke.py``'s K4 phase every build is checked against the current
kernel (largest difference printed) and timed by
``chip_smoke.kernel_time_ms`` (each launch behind a 128 MB write that
flushes L2), median of 30 launches, the order forward then backward.  One
JSON line per build and per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "turns"


def build(sources):
    """{label: loaded library}, all sources compiled at once."""
    from adaptiveisp_tpu_torch.ops.cuda import build as kbuild

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {label: subprocess.Popen(
        [kbuild.nvcc_path(), *kbuild.flags("pipeline_fwd"), "-o",
         str(OUT / f"{label}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, src in sources.items()}
    libs = {}
    for label, proc in procs.items():
        log = proc.communicate()[0]
        print(json.dumps({"build": label, "rc": proc.returncode,
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln]}),
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(log)
        libs[label] = ctypes.CDLL(str(OUT / f"{label}.so"))
    return libs


def main() -> int:
    import torch

    import chip_smoke
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops.cuda import build as kbuild
    from adaptiveisp_tpu_torch.ops.cuda import pipeline as cp

    ap = argparse.ArgumentParser()
    ap.add_argument("--packed", action="append", default=[])
    ap.add_argument("others", nargs="*")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device()
    packed = {f"packed_{Path(p).stem}" for p in a.packed}
    libs = build({"kernel": kbuild.CSRC / "pipeline_fwd.cu",
                  **{f"packed_{Path(p).stem}": p for p in a.packed},
                  **{Path(p).stem: p for p in a.others}})
    cfg = Config()
    dev = torch.device("cuda")
    rng = np.random.RandomState(30)
    n, size = chip_smoke.SERVE_BATCH, chip_smoke.SERVE_SIZE
    cases = {
        "bench5_8x512": (rng.rand(n, size, size, 3), chip_smoke._stages_5(
            n, rng)),
        "sharpen4_4k": (rng.rand(1, *chip_smoke.UHD, 3),
                        chip_smoke._sharpen4(1, rng)),
        "pointwise_4k": (rng.uniform(-0.1, 1.1, (1, *chip_smoke.UHD, 3)),
                         chip_smoke._pointwise_stack(1, rng)),
    }
    for label, (img_np, stages_np) in cases.items():
        img = torch.from_numpy(img_np.astype(np.float32)).to(dev)
        stages = [(nm, torch.from_numpy(p).to(dev)) for nm, p in stages_np]
        keep, runs, outs = [], {}, {}
        for var, lib in libs.items():
            fn = lib.pipeline_fwd
            args, out, rows = cp.launch_args(cfg, img, stages)
            if var in packed:
                fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                               + [ctypes.POINTER(ctypes.c_int)] * 3
                               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
                params = cp.pack_params(cfg, img, stages)
                args = (args[0], args[1], params.data_ptr(), params.shape[1],
                        *args[2:5], *args[7:])
                rows = (rows, params)
            else:
                fn.argtypes = cp._entry().argtypes
            keep.append(rows)
            runs[var] = (lambda fn=fn, args=args: fn(*args))
            runs[var]()
            outs[var] = out
        torch.cuda.synchronize()
        order = list(runs) + list(reversed(list(runs)))
        times = {k: [] for k in runs}
        for k in order:
            times[k].append(chip_smoke.kernel_time_ms(runs[k], 30))
        print(json.dumps({
            "case": label, "shape": list(img.shape),
            "stages": [nm for nm, _ in stages], "ms": times,
            "max_abs_diff_vs_kernel": {
                k: float((o - outs["kernel"]).abs().max())
                for k, o in outs.items()}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
