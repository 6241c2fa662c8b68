#!/usr/bin/env python3
"""Where the time of the port's NLM kernels goes, by ablation, on one GPU.

    python3 tools/nlm_kernel_ablation.py     # from the repository root

Builds text-edited copies of ``csrc/nlm_fwd.cu`` (K1) and ``csrc/nlm_bwd.cu``
(K2) into ``build/ablation/`` (one ``nvcc`` per copy, all at once), each
with one part of the work removed, and times them in turns with the
unedited kernel at the main NLM case of ``chip_smoke.py``
([8,512,512,3], 5 of 8 images on): CUDA events, median of 30 launches, the
order forward then backward.  The ablated results are wrong by design; only
``divide`` (the weight as s / hh, no hoisted reciprocal) computes the
function, and its error against the kernel is printed.  One JSON line per
variant's build and per kernel, then the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "ablation"
SYNC = "  __syncthreads();\n\n  // {}."
K1_EDITS = {
    "divide": [("const float inv_hh = 1.0f / (fmaxf(h[n], 0.0f) + 1e-8f);",
                "const float inv_hh = fmaxf(h[n], 0.0f) + 1e-8f;"),
               ("* inv_hh);", "/ inv_hh);")],
    "no_accumulate": [("  // 3. w_d(p) pairs with",
                       "  if (dy >= 0) return;\n  // 3. w_d(p) pairs with")],
    "no_chain": [("w[j] = expf(-sqrtf(fmaxf(box, 0.0f)) * inv_hh);",
                  "w[j] = box * inv_hh;")],
    "no_barriers": [(SYNC.format(k), f"\n  // {k}.") for k in (2, 3)],
}
K2_EDITS = {
    "divide": [("  c.w = expf(-c.s * inv_hh);", "  c.w = expf(-c.s / hh);"),
               ("Chain chain(const float* v, float inv_hh)",
                "Chain chain(const float* v, float hh)"),
               ("chain(p.cs + xr * CSP + xc, inv_hh)",
                "chain(p.cs + xr * CSP + xc, hh)")],
    "no_chain": [("  c.s = c.pos ? sqrtf(b) : 0.0f;\n"
                  "  c.w = expf(-c.s * inv_hh);",
                  "  c.s = b;\n  c.w = b * inv_hh;"),
                 ("-0.5f * gww / (hh * c.s)", "-0.5f * gww * c.s")],
    "no_barriers": [(SYNC.format(k), f"\n  // {k}.") for k in (2, 3, 4, 5)],
    "no_halo_cells": [("i < bands + TH * SIDE;", "i < 0;")],
    "no_z_gather": [("  // 4. Z = 2", "  if (dy >= 0) return;\n  // 4. Z = 2")],
}


def edited(src: str, edits):
    for old, new in edits:
        if old not in src:
            raise ValueError(f"edit target not in the source: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(build, name, edits):
    """{variant: loaded library}, the unedited source as ``kernel``."""
    src = (build.CSRC / f"{name}.cu").read_text()
    variants = {"kernel": src, **{k: edited(src, e) for k, e in edits.items()}}
    procs = {}
    for var, text in variants.items():
        cu = OUT / f"{name}_{var}.cu"
        cu.write_text(text)
        procs[var] = subprocess.Popen(
            [build.nvcc_path(), *build.flags(name), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for var, proc in procs.items():
        log = proc.communicate()[0]
        print(json.dumps({"build": f"{name}_{var}", "rc": proc.returncode,
                          "ptxas": [ln.strip() for ln in log.splitlines()
                                    if "registers" in ln or "spill" in ln]}),
              flush=True)
        if proc.returncode != 0:
            raise RuntimeError(log)
        libs[var] = ctypes.CDLL(str(OUT / f"{name}_{var}.so"))
    return libs


def in_turns(runs, reps=30):
    import chip_smoke

    order = list(runs) + list(reversed(list(runs)))
    times = {k: [] for k in runs}
    for k in order:
        times[k].append(chip_smoke.cuda_time_ms(runs[k], reps))
    return times


def main() -> int:
    import torch

    import chip_smoke
    from adaptiveisp_tpu_torch.ops.cuda import build
    from adaptiveisp_tpu_torch.ops.cuda import nlm as cnlm
    from adaptiveisp_tpu_torch.ops.math import clip_grad_mask

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    smi = chip_smoke.phase_device()
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    _, rgb, h, gate_np = next(chip_smoke._nlm_cases(rng, dev, [1, 0]))
    gate = torch.from_numpy(gate_np[:, None]).to(dev)
    n, hgt, wid, _ = rgb.shape
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [rgb.data_ptr(), h.data_ptr(), gate.data_ptr()]

    # K1
    runs, outs = {}, {}
    for var, lib in build_variants(build, "nlm_fwd", K1_EDITS).items():
        fn = lib.nlm_gray_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        u = torch.empty_like(rgb)
        w = torch.empty((n, hgt, wid, 1), device=dev)
        runs[var] = (lambda fn=fn, u=u, w=w: fn(
            *ptr, u.data_ptr(), w.data_ptr(), n, hgt, wid, stream))
        runs[var]()
        outs[var] = u
    torch.cuda.synchronize()
    print(json.dumps({"kernel": "nlm_gray_fwd", "ms": in_turns(runs),
                      "divide_max_abs_diff": float(
                          (outs["divide"] - outs["kernel"]).abs().max())}),
          flush=True)

    # K2, on K1's outputs and a seeded cotangent
    u, wsum = cnlm.nlm_gray_fwd(rgb, h, gate)
    g = torch.from_numpy(rng.randn(n, hgt, wid, 3).astype(np.float32))
    v = (g.to(dev) * clip_grad_mask(u, 0.0, 1.0)).contiguous()
    runs, outs = {}, {}
    for var, lib in build_variants(build, "nlm_bwd", K2_EDITS).items():
        fn = lib.nlm_gray_bwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        dr = torch.empty_like(rgb)
        part = torch.empty((n, lib.nlm_gray_bwd_blocks(hgt, wid)),
                           device=dev)
        runs[var] = (lambda fn=fn, dr=dr, part=part: fn(
            *ptr, v.data_ptr(), u.data_ptr(), wsum.data_ptr(),
            dr.data_ptr(), part.data_ptr(), n, hgt, wid, stream))
        runs[var]()
        outs[var] = dr
    torch.cuda.synchronize()
    print(json.dumps({"kernel": "nlm_gray_bwd", "ms": in_turns(runs),
                      "divide_max_abs_diff": float(
                          (outs["divide"] - outs["kernel"]).abs().max())}),
          flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
