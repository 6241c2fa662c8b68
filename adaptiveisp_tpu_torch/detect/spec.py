"""YOLO architecture specs used by the port (copy of the YOLOv3 and
YOLOv3-tiny entries of ``adaptiveisp_tpu/detect/spec.py``; the port keeps its
own copy so it never imports the JAX package).

Each row is [from, number, module, args]:
  from   -1 for previous layer, an int index, or a list of indices (Concat)
  number repetition count
  module Conv | Bottleneck | Upsample | Concat | MaxPool | ZeroPad | Detect
  args   module-specific ctor args (channels, kernel, stride, ...)
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


def flatten_layers(spec: Dict[str, Any]) -> List[list]:
    return list(spec["backbone"]) + list(spec["head"])


def resolve_spec(name_or_spec) -> Dict[str, Any]:
    """A spec dict as is, or a named spec the port has (``yolov3``,
    ``yolov3-tiny``, case-insensitive); any other name raises
    ``NotImplementedError``, as an unported layer does."""
    if isinstance(name_or_spec, dict):
        return name_or_spec
    named = {"yolov3": YOLOV3_SPEC, "yolov3-tiny": YOLOV3_TINY_SPEC}
    spec = named.get(str(name_or_spec).lower())
    if spec is None:
        raise NotImplementedError(
            f"detector spec {name_or_spec!r} is not ported; the port has "
            f"{sorted(named)}")
    return spec
