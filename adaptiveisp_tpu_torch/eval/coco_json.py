"""COCO-format prediction dump and optional pycocotools rescoring (port of
``adaptiveisp_tpu/eval/coco_json.py``).

Accumulate per-image detections as COCO records, write
``predictions.json``, and, where pycocotools is importable, score it
against an annotation file (the reference's save-json path,
val_adaptiveisp.py:422-449).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

# COCO 80-class index -> COCO 91-class category id (reference coco80_to_coco91)
COCO80_TO_91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90]


def image_id_from_path(path: str) -> int | str:
    stem = os.path.splitext(os.path.basename(path))[0]
    return int(stem) if stem.isnumeric() else stem


def detections_to_coco(path: str, det_xyxy: np.ndarray,
                       class_map=None) -> List[Dict]:
    """det_xyxy: [n, 6] (x1, y1, x2, y2, conf, cls) in original-image
    pixels -> COCO records with corner-anchored xywh boxes."""
    image_id = image_id_from_path(path)
    boxes = det_xyxy[:, :4].copy()
    boxes[:, 2:] -= boxes[:, :2]  # xyxy -> xywh
    out = []
    for row, box in zip(det_xyxy, boxes):
        cls = int(row[5])
        if class_map is not None:
            cls = class_map[cls]
        out.append({
            "image_id": image_id,
            "category_id": cls,
            "bbox": [round(float(v), 3) for v in box],
            "score": round(float(row[4]), 5),
        })
    return out


def save_predictions(records: List[Dict], save_dir: str,
                     name: str = "predictions.json") -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def pycocotools_eval(pred_json: str, anno_json: str) -> Optional[Dict]:
    """Official COCO mAP rescoring; None when pycocotools is absent (the
    reference also soft-fails, val_adaptiveisp.py:444-449)."""
    try:
        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval
    except ImportError:
        return None
    anno = COCO(anno_json)
    pred = anno.loadRes(pred_json)
    ev = COCOeval(anno, pred, "bbox")
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return {"map": float(ev.stats[0]), "map50": float(ev.stats[1])}
