"""Box utilities for NMS and the detector loss (port of part of
``adaptiveisp_tpu/detect/boxes.py``; the host-side numpy helpers come with
evaluation and the ``Detections`` container)."""

from __future__ import annotations

import math

import torch

from adaptiveisp_tpu_torch.ops.math import clip


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


def bbox_ciou(box1, box2, eps: float = 1e-7):
    """Complete IoU between xywh boxes of equal shape [..., 4]; alpha is a
    constant (detached), as in the original.  The clips take JAX's tie
    gradients, and ``torch.minimum``/``maximum`` split a tie in half as
    ``jnp``'s do."""
    x1, y1, w1, h1 = box1.unbind(-1)
    x2, y2, w2, h2 = box2.unbind(-1)
    b1x1, b1x2 = x1 - w1 / 2, x1 + w1 / 2
    b1y1, b1y2 = y1 - h1 / 2, y1 + h1 / 2
    b2x1, b2x2 = x2 - w2 / 2, x2 + w2 / 2
    b2y1, b2y2 = y2 - h2 / 2, y2 + h2 / 2

    inter = (clip(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1), 0.0)
             * clip(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1),
                    0.0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2
            + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * (
        torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)
