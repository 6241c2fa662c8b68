"""Least time of the port's hand-written kernels for given inputs: each input
byte read once, each output byte written once, and the least arithmetic the
function needs (frozen copies of the bounds that ``chip_smoke.py`` keeps for
K1, K2 and K4)."""

from __future__ import annotations

from benchmark.roofline.peaks import FLOPS, HBM_BYTES_PER_S, SFU_OPS_PER_S

FP32_OPS_PER_S = FLOPS["float32"]


def bound(nbytes: int, ops: int, sfu_ops: int):
    """Least time for this work: bytes over the HBM rate against FP32
    operations over the FP32 rate (the special-function units' time
    beside it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "sfu_ms": sfu_ops / SFU_OPS_PER_S * 1e3}


def nlm_bound(n_on: int, n: int, h: int, w: int):
    """The gated NLM forward (K1) for these inputs.  The weight of offset
    -d at p is that of d at p - d, so per gated-on pixel the least
    arithmetic is 60 weights of 13 operations (difference, square,
    separable 5x5 box sum, sqrt, divide, exp; 3 of them on the
    special-function units) and 121 terms of 7 (weight sum and three
    multiply-adds)."""
    px_on, px = n_on * h * w, n * h * w
    return bound(px_on * 12 + px * 16 + n * 8, px_on * (60 * 13 + 121 * 7),
                 px_on * 60 * 3)


def nlm_bwd_bound(n_on: int, n: int, h: int, w: int):
    """The gated NLM backward (K2) for these inputs: rgb, v and U (12 bytes
    a pixel each) and W (4) read once for the gated-on images, dL/drgb (12)
    written for every image.  Per gated-on pixel, for each of the 60 offset
    pairs, the forward's weight of 13 operations (3 on the special-function
    units) and 43 for both offsets' adjoints, 1 of them (the divide) on the
    special-function units."""
    px_on, px = n_on * h * w, n * h * w
    return bound(px_on * (12 * 3 + 4) + px * 12 + n * 12,
                 px_on * 60 * (13 + 43), px_on * 60 * (3 + 1))


# stage -> least FP32 operations per pixel (all three channels) and the
# special-function-unit share of them, for the K4 bound
STAGE_OPS = {
    "exposure": (3, 0), "improved_wb": (3, 0), "ccm": (15, 0),
    "gamma": (12, 6),          # max, log, multiply, exp per channel
    "tone": (123, 0),          # 8 x (subtract, clip 2, multiply-add 2) + 1
    "color": (123, 0),
    "contrast": (30, 4),       # luminance, clip, cos, 3 divides, 3 lerps
    "wnb": (14, 0),
    "saturation_plus": (60, 4),
    "sharpen": (66, 0),        # 3 x (9 multiply-adds, mix, clip)
    "sharpen_v2": (66, 0),
}


def pipeline_bound(names, n: int, h: int, w: int, n_params: int):
    """K4 for these inputs: the image read once and written once (24 bytes
    a pixel) and one parameter row per image read once; per pixel the least
    arithmetic of each stage (STAGE_OPS)."""
    px = n * h * w
    ops = sum(STAGE_OPS[nm][0] for nm in names)
    sfu = sum(STAGE_OPS[nm][1] for nm in names)
    return bound(px * 24 + n * n_params * 4, px * ops, px * sfu)
