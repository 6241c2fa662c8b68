"""Test-time augmented (TTA) inference (port of
``adaptiveisp_tpu/detect/tta.py``).

Three detector passes: full scale, 0.83x with a left-right flip, and 0.67x.
Each pass is decoded, de-scaled back into the input's pixel frame, its
redundant pyramid tail clipped, and the three are concatenated before NMS
(the reference's ``--augment``, models/yolo.py:205-252).  A scaled size is
padded up to a multiple of the model's largest stride.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from adaptiveisp_tpu_torch.detect.model import (
    decode_predictions,
    model_strides,
)
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC

#: the reference's scale/flip schedule; "lr" flips the width axis
TTA_SCALES: Tuple[float, ...] = (1.0, 0.83, 0.67)
TTA_FLIPS: Tuple[Optional[str], ...] = (None, "lr", None)

_PAD_VALUE = 0.447  # imagenet mean, the reference's pad fill


def scale_img(x: torch.Tensor, ratio: float, gs: int = 32) -> torch.Tensor:
    """Resize NHWC images by ``ratio`` (bilinear, half-pixel centres, no
    antialiasing) and pad bottom/right with 0.447 to a ``gs`` multiple
    (reference torch_utils.py:297-306)."""
    if ratio == 1.0:
        return x
    n, h, w, c = x.shape
    sh, sw = int(h * ratio), int(w * ratio)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(sh, sw), mode="bilinear",
                      align_corners=False)
    ph = math.ceil(h * ratio / gs) * gs
    pw = math.ceil(w * ratio / gs) * gs
    y = F.pad(y, (0, pw - sw, 0, ph - sh), value=_PAD_VALUE)
    return y.permute(0, 2, 3, 1).contiguous()


def descale_pred(p: torch.Tensor, flip: Optional[str], scale: float,
                 img_size: Tuple[int, int]) -> torch.Tensor:
    """Invert the augmentation on decoded [N, n, no] xywh predictions
    (reference yolo.py:225-240, non-inplace branch)."""
    x, y, wh = p[..., 0:1] / scale, p[..., 1:2] / scale, p[..., 2:4] / scale
    if flip == "ud":
        y = img_size[0] - y
    elif flip == "lr":
        x = img_size[1] - x
    return torch.cat([x, y, wh, p[..., 4:]], dim=-1)


def clip_augmented(ys: Sequence[torch.Tensor], nl: int) -> list:
    """Drop the redundant pyramid tails (reference yolo.py:242-251): the
    full-scale pass loses its coarsest level's rows, the smallest-scale
    pass its finest level's rows."""
    ys = list(ys)
    g = sum(4 ** k for k in range(nl))
    i = ys[0].shape[1] // g
    ys[0] = ys[0][:, :-i]
    i = (ys[-1].shape[1] // g) * 4 ** (nl - 1)
    ys[-1] = ys[-1][:, i:]
    return ys


def forward_augment(fwd_fn: Callable[[torch.Tensor], Sequence[torch.Tensor]],
                    x: torch.Tensor, spec=None,
                    scales: Sequence[float] = TTA_SCALES,
                    flips: Sequence[Optional[str]] = TTA_FLIPS
                    ) -> torch.Tensor:
    """Augmented inference: decoded, de-scaled, clipped and concatenated
    predictions [N, total, no] ready for NMS.  ``fwd_fn`` maps NHWC images
    to the model's per-level raw logits (e.g. a ``DetectionModel``)."""
    spec = spec or YOLOV3_SPEC
    h, w = int(x.shape[1]), int(x.shape[2])
    gs = max(model_strides(spec))
    ys = []
    for si, fi in zip(scales, flips):
        if fi == "lr":
            xi = torch.flip(x, dims=(2,))
        elif fi == "ud":
            xi = torch.flip(x, dims=(1,))
        else:
            xi = x
        yi = decode_predictions(fwd_fn(scale_img(xi, si, gs=gs)), spec)
        ys.append(descale_pred(yi, fi, si, (h, w)))
    return torch.cat(clip_augmented(ys, nl=len(spec["anchors"])), dim=1)
