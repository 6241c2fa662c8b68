"""Box utilities NMS needs (port of part of
``adaptiveisp_tpu/detect/boxes.py``; the host-side numpy helpers come with
evaluation and the ``Detections`` container)."""

from __future__ import annotations

import torch


def xywh2xyxy(x):
    xy, wh = x[..., 0:2], x[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def box_iou(box1, box2, eps: float = 1e-7):
    """Pairwise IoU of xyxy boxes: [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    a1, a2 = box1[..., :, None, :2], box1[..., :, None, 2:4]
    b1, b2 = box2[..., None, :, :2], box2[..., None, :, 2:4]
    inter = torch.clamp(torch.minimum(a2, b2) - torch.maximum(a1, b1),
                        min=0).prod(-1)
    area1 = (a2 - a1).prod(-1)
    area2 = (b2 - b1).prod(-1)
    return inter / (area1 + area2 - inter + eps)
