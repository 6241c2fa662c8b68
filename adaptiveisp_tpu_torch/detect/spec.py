"""YOLO architecture specs (copy of ``adaptiveisp_tpu/detect/spec.py``; the
port keeps its own copy so it never imports the JAX package).

Each row is [from, number, module, args]:
  from   -1 for previous layer, an int index, or a list of indices (Concat)
  number repetition count (scaled by ``depth_multiple``)
  module Conv | Bottleneck | C3 | C3x | C3TR | C3SPP | C3Ghost |
         BottleneckCSP | SPP | SPPF | Focus | DWConv | GhostConv |
         GhostBottleneck | CrossConv | Contract | Expand | Upsample |
         Concat | MaxPool | ZeroPad | Identity | Detect
  args   module-specific ctor args (channels, kernel, stride, ...)

:func:`named_specs` is the zoo (YOLOv3, -tiny, -spp, the YOLOv5 family and
its hub variants); :func:`resolve_spec` takes a name, a YAML path or a dict.
"""

from __future__ import annotations

from typing import Any, Dict, List

YOLOV3_SPEC: Dict[str, Any] = {
    "nc": 80,
    "depth_multiple": 1.0,
    "width_multiple": 1.0,
    "anchors": [
        [10, 13, 16, 30, 33, 23],      # P3/8
        [30, 61, 62, 45, 59, 119],     # P4/16
        [116, 90, 156, 198, 373, 326], # P5/32
    ],
    # darknet53 backbone (yolov3.yaml:13-26)
    "backbone": [
        [-1, 1, "Conv", [32, 3, 1]],
        [-1, 1, "Conv", [64, 3, 2]],
        [-1, 1, "Bottleneck", [64]],
        [-1, 1, "Conv", [128, 3, 2]],
        [-1, 2, "Bottleneck", [128]],
        [-1, 1, "Conv", [256, 3, 2]],
        [-1, 8, "Bottleneck", [256]],
        [-1, 1, "Conv", [512, 3, 2]],
        [-1, 8, "Bottleneck", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],
        [-1, 4, "Bottleneck", [1024]],
    ],
    # FPN head (yolov3.yaml:29-51)
    "head": [
        [-1, 1, "Bottleneck", [1024, False]],
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Conv", [1024, 3, 1]],
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Conv", [1024, 3, 1]],      # 15 (P5/32-large)
        [-2, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Conv", [512, 3, 1]],       # 22 (P4/16-medium)
        [-2, 1, "Conv", [128, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [256, False]],
        [-1, 2, "Bottleneck", [256, False]],  # 27 (P3/8-small)
        [[27, 22, 15], 1, "Detect", ["nc", "anchors"]],
    ],
}

# yolov3-tiny for the lighter model family the reference ships alongside
# (yolov3/models/yolov3-tiny.yaml).
YOLOV3_TINY_SPEC: Dict[str, Any] = {
    "nc": 80,
    "depth_multiple": 1.0,
    "width_multiple": 1.0,
    "anchors": [
        [10, 14, 23, 27, 37, 58],
        [81, 82, 135, 169, 344, 319],
    ],
    "backbone": [
        [-1, 1, "Conv", [16, 3, 1]],
        [-1, 1, "MaxPool", [2, 2]],
        [-1, 1, "Conv", [32, 3, 1]],
        [-1, 1, "MaxPool", [2, 2]],
        [-1, 1, "Conv", [64, 3, 1]],
        [-1, 1, "MaxPool", [2, 2]],
        [-1, 1, "Conv", [128, 3, 1]],
        [-1, 1, "MaxPool", [2, 2]],
        [-1, 1, "Conv", [256, 3, 1]],
        [-1, 1, "MaxPool", [2, 2]],
        [-1, 1, "Conv", [512, 3, 1]],
        [-1, 1, "ZeroPad", [[0, 1, 0, 1]]],
        [-1, 1, "MaxPool", [2, 1]],
    ],
    "head": [
        [-1, 1, "Conv", [1024, 3, 1]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Conv", [512, 3, 1]],  # 15 (P5/32-large)
        [-2, 1, "Conv", [128, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 1, "Conv", [256, 3, 1]],  # 19 (P4/16-medium)
        [[19, 15], 1, "Detect", ["nc", "anchors"]],
    ],
}


# yolov5-s: the CSP model family (C3 + SPPF + compound depth/width scaling)
# the spec-driven DetectionModel supports beyond darknet53 — the public
# ultralytics/yolov5 v6 architecture at gd=0.33/gw=0.50.
YOLOV5S_SPEC: Dict[str, Any] = {
    "nc": 80,
    "depth_multiple": 0.33,
    "width_multiple": 0.50,
    "anchors": [
        [10, 13, 16, 30, 33, 23],
        [30, 61, 62, 45, 59, 119],
        [116, 90, 156, 198, 373, 326],
    ],
    "backbone": [
        [-1, 1, "Conv", [64, 6, 2, 2]],   # 0 P1/2 (6x6 stem, explicit pad)
        [-1, 1, "Conv", [128, 3, 2]],     # 1 P2/4
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],     # 3 P3/8
        [-1, 6, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],     # 5 P4/16
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [1024, 3, 2]],    # 7 P5/32
        [-1, 3, "C3", [1024]],
        [-1, 1, "SPPF", [1024, 5]],       # 9
    ],
    "head": [
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],      # 13
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],      # 17 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],      # 20 (P4/16-medium)
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],     # 23 (P5/32-large)
        [[17, 20, 23], 1, "Detect", ["nc", "anchors"]],
    ],
}

# ---------------------------------------------------------------------------
# the rest of the reference model zoo (models/*.yaml + models/hub/*.yaml),
# authored as spec data from the published architectures.

def _with(spec: Dict[str, Any], **overrides) -> Dict[str, Any]:
    """Shallow-copy a spec with field overrides (scale presets, activation)."""
    out = dict(spec)
    out.update(overrides)
    return out


def _auto_anchors(nl: int, na: int = 3) -> List[List[int]]:
    """Placeholder anchors for `anchors: <int>` specs (reference
    yolo.py:335-336) — AutoAnchor evolves the real ones before training."""
    return [list(range(na * 2)) for _ in range(nl)]


# yolov3-spp: darknet53 + SPP head (models/yolov3-spp.yaml) — identical to
# YOLOV3_SPEC except head rows 11-12 (SPP[512,[5,9,13]] + Conv[1024,3,1]
# replace the Conv[512,1,1]+Conv[1024,3,1] pair after the first Bottleneck).
YOLOV3_SPP_SPEC: Dict[str, Any] = _with(
    YOLOV3_SPEC,
    head=[
        [-1, 1, "Bottleneck", [1024, False]],
        [-1, 1, "SPP", [512, [5, 9, 13]]],
        [-1, 1, "Conv", [1024, 3, 1]],
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Conv", [1024, 3, 1]],      # 15 (P5/32-large)
        [-2, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Bottleneck", [512, False]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Conv", [512, 3, 1]],       # 22 (P4/16-medium)
        [-2, 1, "Conv", [128, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Bottleneck", [256, False]],
        [-1, 2, "Bottleneck", [256, False]],  # 27 (P3/8-small)
        [[27, 22, 15], 1, "Detect", ["nc", "anchors"]],
    ],
)

# compound-scale presets: the yolov5{n,s,m,l,x}.yaml files differ ONLY in
# (depth_multiple, width_multiple) — n .33/.25, s .33/.50, m .67/.75,
# l 1.0/1.0, x 1.33/1.25.
_V5_SCALES = {"n": (0.33, 0.25), "s": (0.33, 0.50), "m": (0.67, 0.75),
              "l": (1.00, 1.00), "x": (1.33, 1.25)}

# P6 family (hub/yolov5{n,s,m,l,x}6.yaml): one more backbone stage to P6/64
# (768-wide P5), a 4-level PAN head, dedicated 4-level anchors.
YOLOV5S6_SPEC: Dict[str, Any] = {
    "nc": 80,
    "depth_multiple": 0.33,
    "width_multiple": 0.50,
    "anchors": [
        [19, 27, 44, 40, 38, 94],          # P3/8
        [96, 68, 86, 152, 180, 137],       # P4/16
        [140, 301, 303, 264, 238, 542],    # P5/32
        [436, 615, 739, 380, 925, 792],    # P6/64
    ],
    "backbone": [
        [-1, 1, "Conv", [64, 6, 2, 2]],    # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],      # 1 P2/4
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],      # 3 P3/8
        [-1, 6, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],      # 5 P4/16
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [768, 3, 2]],      # 7 P5/32
        [-1, 3, "C3", [768]],
        [-1, 1, "Conv", [1024, 3, 2]],     # 9 P6/64
        [-1, 3, "C3", [1024]],
        [-1, 1, "SPPF", [1024, 5]],        # 11
    ],
    "head": [
        [-1, 1, "Conv", [768, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],       # 15
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 19
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],       # 23 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 20], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 26 (P4/16-medium)
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 16], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],       # 29 (P5/32-large)
        [-1, 1, "Conv", [768, 3, 2]],
        [[-1, 12], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],      # 32 (P6/64-xlarge)
        [[23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]],
    ],
}

# hub/yolov5-p6.yaml: the same P6 graph at gd=gw=1.0 with AutoAnchor
# placeholder anchors (`anchors: 3`).
YOLOV5_P6_SPEC: Dict[str, Any] = _with(
    YOLOV5S6_SPEC, depth_multiple=1.0, width_multiple=1.0,
    anchors=_auto_anchors(4))

# hub/yolov5-p7.yaml: P7/128 stage on top of the P6 backbone, 5-level head.
YOLOV5_P7_SPEC: Dict[str, Any] = {
    "nc": 80,
    "depth_multiple": 1.0,
    "width_multiple": 1.0,
    "anchors": _auto_anchors(5),
    "backbone": [
        [-1, 1, "Conv", [64, 6, 2, 2]],    # 0 P1/2
        [-1, 1, "Conv", [128, 3, 2]],      # 1 P2/4
        [-1, 3, "C3", [128]],
        [-1, 1, "Conv", [256, 3, 2]],      # 3 P3/8
        [-1, 6, "C3", [256]],
        [-1, 1, "Conv", [512, 3, 2]],      # 5 P4/16
        [-1, 9, "C3", [512]],
        [-1, 1, "Conv", [768, 3, 2]],      # 7 P5/32
        [-1, 3, "C3", [768]],
        [-1, 1, "Conv", [1024, 3, 2]],     # 9 P6/64
        [-1, 3, "C3", [1024]],
        [-1, 1, "Conv", [1280, 3, 2]],     # 11 P7/128
        [-1, 3, "C3", [1280]],
        [-1, 1, "SPPF", [1280, 5]],        # 13
    ],
    "head": [
        [-1, 1, "Conv", [1024, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],      # 17
        [-1, 1, "Conv", [768, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 8], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],       # 21
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 25
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],       # 29 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 26], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 32 (P4/16-medium)
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 22], 1, "Concat", [1]],
        [-1, 3, "C3", [768, False]],       # 35 (P5/32-large)
        [-1, 1, "Conv", [768, 3, 2]],
        [[-1, 18], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],      # 38 (P6/64-xlarge)
        [-1, 1, "Conv", [1024, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [1280, False]],      # 41 (P7/128-xxlarge)
        [[29, 32, 35, 38, 41], 1, "Detect", ["nc", "anchors"]],
    ],
}

# hub/yolov5-p2.yaml: standard v5 backbone, 4-level (P2..P5) head.
YOLOV5_P2_SPEC: Dict[str, Any] = _with(
    YOLOV5S_SPEC, depth_multiple=1.0, width_multiple=1.0,
    anchors=_auto_anchors(4),
    head=[
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 13
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],       # 17 (P3/8-small)
        [-1, 1, "Conv", [128, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 2], 1, "Concat", [1]],
        [-1, 1, "C3", [128, False]],       # 21 (P2/4-xsmall)
        [-1, 1, "Conv", [128, 3, 2]],
        [[-1, 18], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],       # 24 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 27 (P4/16-medium)
        [-1, 1, "Conv", [512, 3, 2]],
        [[-1, 10], 1, "Concat", [1]],
        [-1, 3, "C3", [1024, False]],      # 30 (P5/32-large)
        [[21, 24, 27, 30], 1, "Detect", ["nc", "anchors"]],
    ],
)

# hub/yolov5-p34.yaml: standard v5 backbone, 2-level (P3, P4) head.
YOLOV5_P34_SPEC: Dict[str, Any] = _with(
    YOLOV5S_SPEC, depth_multiple=0.33, width_multiple=0.50,
    anchors=_auto_anchors(2),
    head=[
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 13
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 3, "C3", [256, False]],       # 17 (P3/8-small)
        [-1, 1, "Conv", [256, 3, 2]],
        [[-1, 14], 1, "Concat", [1]],
        [-1, 3, "C3", [512, False]],       # 20 (P4/16-medium)
        [[17, 20], 1, "Detect", ["nc", "anchors"]],
    ],
)

# hub/yolov5-fpn.yaml: top-down-only FPN head (no PAN down path).
YOLOV5_FPN_SPEC: Dict[str, Any] = _with(
    YOLOV5S_SPEC, depth_multiple=1.0, width_multiple=1.0,
    head=[
        [-1, 3, "C3", [1024, False]],      # 10 (P5/32-large)
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 6], 1, "Concat", [1]],
        [-1, 1, "Conv", [512, 1, 1]],
        [-1, 3, "C3", [512, False]],       # 14 (P4/16-medium)
        [-1, 1, "Upsample", [None, 2, "nearest"]],
        [[-1, 4], 1, "Concat", [1]],
        [-1, 1, "Conv", [256, 1, 1]],
        [-1, 3, "C3", [256, False]],       # 18 (P3/8-small)
        [[18, 14, 10], 1, "Detect", ["nc", "anchors"]],
    ],
)

# hub/yolov5-panet.yaml: the v5 PAN head at gd=gw=1.0 (the standard graph).
YOLOV5_PANET_SPEC: Dict[str, Any] = _with(
    YOLOV5S_SPEC, depth_multiple=1.0, width_multiple=1.0)

# hub/yolov5-bifpn.yaml: PANet + one extra cross-scale edge (the first
# down-path Concat also takes backbone P4 — row 20's 3-way concat).
YOLOV5_BIFPN_SPEC: Dict[str, Any] = _with(
    YOLOV5_PANET_SPEC,
    head=[row if i != 9 else [[-1, 14, 6], 1, "Concat", [1]]
          for i, row in enumerate(YOLOV5S_SPEC["head"])],
)

# hub/yolov5s-ghost.yaml: every non-stem Conv -> GhostConv, C3 -> C3Ghost.
YOLOV5S_GHOST_SPEC: Dict[str, Any] = _with(
    YOLOV5S_SPEC,
    backbone=[[frm, num,
               {"Conv": "GhostConv", "C3": "C3Ghost"}.get(mod, mod)
               if i > 0 else mod, args]
              for i, (frm, num, mod, args)
              in enumerate(YOLOV5S_SPEC["backbone"])],
    head=[[frm, num, {"Conv": "GhostConv", "C3": "C3Ghost"}.get(mod, mod),
           args] for frm, num, mod, args in YOLOV5S_SPEC["head"]],
)

# hub/yolov5s-transformer.yaml: C3TR in the last backbone stage.
YOLOV5S_TRANSFORMER_SPEC: Dict[str, Any] = _with(
    YOLOV5S_SPEC,
    backbone=[row if i != 8 else [-1, 3, "C3TR", [1024]]
              for i, row in enumerate(YOLOV5S_SPEC["backbone"])],
)

# hub/yolov5s-LeakyReLU.yaml: spec-level activation override.
YOLOV5S_LEAKYRELU_SPEC: Dict[str, Any] = _with(
    YOLOV5S_SPEC, activation="leaky_relu")


def named_specs() -> Dict[str, Dict[str, Any]]:
    """Every named model in the zoo (the reference's models/*.yaml +
    models/hub/*.yaml inventory, minus the seg variants which live behind
    the Segment head in detect/segment.py)."""
    out = {
        "yolov3": YOLOV3_SPEC,
        "yolov3-tiny": YOLOV3_TINY_SPEC,
        "yolov3-spp": YOLOV3_SPP_SPEC,
        "yolov5s6": YOLOV5S6_SPEC,
        "yolov5-p2": YOLOV5_P2_SPEC,
        "yolov5-p34": YOLOV5_P34_SPEC,
        "yolov5-p6": YOLOV5_P6_SPEC,
        "yolov5-p7": YOLOV5_P7_SPEC,
        "yolov5-fpn": YOLOV5_FPN_SPEC,
        "yolov5-panet": YOLOV5_PANET_SPEC,
        "yolov5-bifpn": YOLOV5_BIFPN_SPEC,
        "yolov5s-ghost": YOLOV5S_GHOST_SPEC,
        "yolov5s-transformer": YOLOV5S_TRANSFORMER_SPEC,
        "yolov5s-leakyrelu": YOLOV5S_LEAKYRELU_SPEC,
    }
    for size, (gd, gw) in _V5_SCALES.items():
        out[f"yolov5{size}"] = _with(YOLOV5S_SPEC, depth_multiple=gd,
                                     width_multiple=gw)
        if size != "s":
            out[f"yolov5{size}6"] = _with(YOLOV5S6_SPEC, depth_multiple=gd,
                                          width_multiple=gw)
    return out


# ultralytics YAMLs' torch-module spellings -> DetectionModel module names
_MODULE_ALIASES = {
    "nn.Upsample": "Upsample",
    "nn.MaxPool2d": "MaxPool",
    "nn.ZeroPad2d": "ZeroPad",
}


# ultralytics `activation:` YAML spellings (torch module exprs,
# reference yolo.py:302-305 eval()s these) -> activation registry names
_ACT_ALIASES = {
    "nn.silu": "silu", "silu": "silu",
    "nn.leakyrelu": "leaky_relu", "leakyrelu": "leaky_relu",
    "nn.hardswish": "hardswish", "hardswish": "hardswish",
    "nn.relu": "relu", "relu": "relu",
    "nn.relu6": "relu6", "relu6": "relu6",
    "nn.mish": "mish", "mish": "mish",
    "nn.identity": "identity", "identity": "identity",
    "frelu": "frelu", "aconc": "aconc", "metaaconc": "meta_aconc",
    "meta_aconc": "meta_aconc",
}


def _normalize_activation(act):
    if not act or not isinstance(act, str):
        return act
    base = act.split("(", 1)[0].strip().lower()
    return _ACT_ALIASES.get(base, act)


def _normalize(spec: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(spec)
    for part in ("backbone", "head"):
        rows = []
        for frm, num, mod, args in spec[part]:
            rows.append([frm, num, _MODULE_ALIASES.get(str(mod), str(mod)),
                         list(args)])
        out[part] = rows
    if isinstance(out.get("anchors"), int):
        # `anchors: N` = N placeholder anchors per detection level for
        # AutoAnchor to evolve (reference yolo.py:335-336); level count =
        # the Detect/Segment row's input list length.
        for frm, _, mod, _ in reversed(out["head"]):
            if mod in ("Detect", "Segment"):
                out["anchors"] = _auto_anchors(len(frm), out["anchors"])
                break
        else:
            raise ValueError("`anchors: <int>` needs a Detect/Segment row")
    if "activation" in out:
        out["activation"] = _normalize_activation(out["activation"])
    return out


def load_spec(path_or_dict) -> Dict[str, Any]:
    """Load a model spec from a dict or a YAML file path (accepts the
    reference's ultralytics YAML spellings, e.g. nn.Upsample)."""
    if isinstance(path_or_dict, dict):
        return _normalize(path_or_dict)
    import yaml

    with open(path_or_dict, encoding="ascii", errors="ignore") as f:
        return _normalize(yaml.safe_load(f))


def flatten_layers(spec: Dict[str, Any]) -> List[list]:
    return list(spec["backbone"]) + list(spec["head"])


def resolve_spec(name_or_path) -> Dict[str, Any]:
    """Named spec (any :func:`named_specs` key, case-insensitive), YAML
    path, or an already-built dict — the one spec-resolution rule every CLI
    shares."""
    if isinstance(name_or_path, dict):
        return name_or_path
    named = named_specs().get(str(name_or_path).lower())
    return named or load_spec(name_or_path)
