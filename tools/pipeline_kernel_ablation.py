#!/usr/bin/env python3
"""Where the time of the port's fused render kernel (K4) goes, by ablation,
on one GPU.

    python3 tools/pipeline_kernel_ablation.py     # from the repository root

Builds text-edited copies of ``csrc/pipeline_fwd.cu`` into
``build/ablation/`` (one ``nvcc`` per copy, all at once), each with one
part of the work removed, and times them in turns with the unedited kernel
on the three timed cases of ``chip_smoke.py``'s K4 phase (the bench's
5-stage chain at [8,512,512,3], four sharpens and the pointwise stack at
[1,2160,3840,3]): ``chip_smoke.kernel_time_ms`` (each launch behind a 128 MB
write that flushes L2), median of 30 launches, the order forward then
backward.  The ablated results are wrong by design.  One JSON line per
variant's build and per case, then the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tools.nlm_kernel_ablation import OUT, build_variants  # noqa: E402

EDITS = {
    # the sharpen's nine-term blur: every cell keeps its own value
    "no_blur": [("if (!(col_border || gy <= 0 || gy >= H - 1)) {",
                 "if (false) {")],
    # no pointwise stage runs, in either kernel
    "no_stages": [("for (int s = from; s < to; ++s)\n",
                   "for (int s = to; s < to; ++s)\n")],
    # the tiled kernel copies no rows into its staging buffer
    "no_staging": [("cp_async16(xs + r * T::PX + lo, a0 + 4 * lo);",
                    "(void)a0;")],
    # the tiled kernel writes no output row to device memory
    "no_store": [("for (int r = tid >> 5; r < rows; r += NT / 32) {",
                  "for (int r = tid >> 5; r < 0; r += NT / 32) {")],
    # the tiled kernel's barriers between its passes
    "no_barriers": [("    cp_async_wait_all();\n    __syncthreads();\n",
                     "    cp_async_wait_all();\n"),
                    ("if (m > 0) __syncthreads();", "if (m < 0) __syncthreads();"),
                    ("    }\n    __syncthreads();\n\n    float* cur = work;",
                     "    }\n\n    float* cur = work;"),
                    ("    }\n    __syncthreads();\n\n    // the tile, with",
                     "    }\n\n    // the tile, with"),
                    ("    }\n    __syncthreads();\n\n    // the output rows",
                     "    }\n\n    // the output rows")],
}


def main() -> int:
    import torch

    import chip_smoke
    from adaptiveisp_tpu_torch.config import Config
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.cuda import pipeline as cp

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    smi = chip_smoke.phase_device()
    libs = build_variants(build, "pipeline_fwd", EDITS)
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
        args, _, rows = cp.launch_args(cfg, img, stages)
        runs = {}
        for var, lib in libs.items():
            fn = lib.pipeline_fwd
            fn.argtypes = cp._entry().argtypes
            runs[var] = (lambda fn=fn: fn(*args))
        order = list(runs) + list(reversed(list(runs)))
        times = {k: [] for k in runs}
        for k in order:
            times[k].append(chip_smoke.kernel_time_ms(runs[k], 30))
        print(json.dumps({"case": label, "shape": list(img.shape),
                          "stages": [nm for nm, _ in stages],
                          "ms": times}), flush=True)
        del args, rows
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
