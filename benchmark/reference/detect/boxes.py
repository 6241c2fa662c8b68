"""Box utilities (port of ``adaptiveisp_tpu/detect/boxes.py``): tensor
versions for NMS and the detector loss, and the host-side NumPy helpers of
the data layer (``xywhn2xyxy``, ``xyxy2xywhn``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.ops.math import clip


def xywh2xyxy(x):
    xy, wh = x[..., 0:2], x[..., 2:4]
    return torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)


def xywhn2xyxy(x, w, h, padw=0.0, padh=0.0):
    """Normalised xywh -> pixel xyxy, NumPy."""
    y = np.copy(np.asarray(x))
    y[..., 0] = w * (x[..., 0] - x[..., 2] / 2) + padw
    y[..., 1] = h * (x[..., 1] - x[..., 3] / 2) + padh
    y[..., 2] = w * (x[..., 0] + x[..., 2] / 2) + padw
    y[..., 3] = h * (x[..., 1] + x[..., 3] / 2) + padh
    return y


def xyxy2xywhn(x, w, h, clip=False, eps=0.0):
    """Pixel xyxy -> normalised xywh, NumPy; ``clip`` first clips the
    corners to [0, w - eps] x [0, h - eps]."""
    y = np.copy(np.asarray(x))
    if clip:
        y[..., [0, 2]] = y[..., [0, 2]].clip(0, w - eps)
        y[..., [1, 3]] = y[..., [1, 3]].clip(0, h - eps)
    out = np.copy(y)
    out[..., 0] = ((y[..., 0] + y[..., 2]) / 2) / w
    out[..., 1] = ((y[..., 1] + y[..., 3]) / 2) / h
    out[..., 2] = (y[..., 2] - y[..., 0]) / w
    out[..., 3] = (y[..., 3] - y[..., 1]) / h
    return out


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
