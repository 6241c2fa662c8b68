"""Dataset definitions: YAML files and the built-in names (port of
``adaptiveisp_tpu/data/dataset_config.py``).  A definition names the
train/val/test lists, the class count and names, and the image source
(``raw``, ``normalize`` or ``rod``).
"""

from __future__ import annotations

import os
from typing import Dict

import yaml

COCO_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]

# Built-in dataset defs mirroring the reference's data YAMLs
# (yolov3/data/lod.yaml:10-13, coco-2017.yaml, rod.yaml, oprd.yaml).
BUILTIN_DATASETS: Dict[str, Dict] = {
    "lod": {
        "path": "datasets/LOD",
        "train": "RAW_dark_train.txt",
        "val": "RAW_dark_val.txt",
        "test": "RAW_dark_test.txt",
        "nc": 80,
        "names": dict(enumerate(COCO_NAMES)),
        "source": "normalize",
    },
    "coco": {
        "path": "datasets/coco2017",
        "train": "train2017.txt",
        "val": "val2017.txt",
        "nc": 80,
        "names": dict(enumerate(COCO_NAMES)),
        "source": "raw",
    },
    "rod": {
        "path": "datasets/ROD",
        "train": "train.txt",
        "val": "val.txt",
        "nc": 6,
        "names": {0: "car", 1: "truck", 2: "bus", 3: "person", 4: "bicycle",
                  5: "motorcycle"},
        "source": "rod",
    },
}


def check_dataset(data) -> Dict:
    """Resolve a dataset def: builtin name, YAML path, or dict."""
    if isinstance(data, dict):
        d = dict(data)
    elif data in BUILTIN_DATASETS:
        d = dict(BUILTIN_DATASETS[data])
    elif os.path.isfile(str(data)):
        with open(data, errors="ignore") as f:
            d = yaml.safe_load(f)
    else:
        raise FileNotFoundError(f"Dataset '{data}' not found (builtin names: "
                                f"{sorted(BUILTIN_DATASETS)})")
    root = d.get("path", "")
    for split in ("train", "val", "test"):
        if split in d and d[split] and not os.path.isabs(str(d[split])):
            d[split] = os.path.join(root, str(d[split]))
    if isinstance(d.get("names"), list):
        d["names"] = dict(enumerate(d["names"]))
    d.setdefault("nc", len(d.get("names", {})) or 80)
    return d
