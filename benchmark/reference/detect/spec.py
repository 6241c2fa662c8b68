"""The YOLOv3 spec and spec loading (frozen copy of the port's
``detect/spec.py``, its YOLOv3 and loader only).

Each row is [from, number, module, args]:
  from   -1 for previous layer, an int index, or a list of indices (Concat)
  number repetition count (scaled by ``depth_multiple``)
  module Conv | Bottleneck | Upsample | Concat | Detect (the layers YOLOv3
         uses)
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


# ultralytics YAMLs' torch-module spellings -> DetectionModel module names
_MODULE_ALIASES = {
    "nn.Upsample": "Upsample",
}


def load_spec(spec: Dict[str, Any]) -> Dict[str, Any]:
    """A spec dict (as a configuration file holds it) with the ultralytics
    module spellings mapped to this package's names."""
    out = dict(spec)
    for part in ("backbone", "head"):
        out[part] = [[frm, num, _MODULE_ALIASES.get(str(mod), str(mod)),
                      list(args)] for frm, num, mod, args in spec[part]]
    return out


def flatten_layers(spec: Dict[str, Any]) -> List[list]:
    return list(spec["backbone"]) + list(spec["head"])
