"""Spec-driven YOLO detection model (port of the YOLOv3 / YOLOv3-tiny part
of ``adaptiveisp_tpu/detect/model.py``).

``DetectionModel`` builds the layer list of a spec as an ``nn.ModuleList``
named ``model`` (a row repeated n > 1 times is an ``nn.Sequential``), so the
state-dict keys are ultralytics' ``model.{i}.*`` / ``model.{i}.{r}.*``.  It
takes NHWC images, runs NCHW inside, and returns the raw per-level logits in
the JAX package's order [N, ny, nx, na, no] (not ultralytics'
[N, na, ny, nx, no]): candidate order feeds NMS top-k and its ties.
In train mode (``model.train()``) it returns the same raw per-level logits
with BatchNorm on the batch's statistics (flax's, see ``layers.py``): the
JAX model's ``train=True`` forward, which ``loss.batch_loss`` takes.
:func:`decode_predictions` turns them into pixel-space boxes.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaptiveisp_tpu_torch.detect.layers import (
    Bottleneck,
    Concat,
    ConvBNAct,
    MaxPool,
    Upsample,
    ZeroPad,
)
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC, flatten_layers


class Detect(nn.Module):
    """Per-level 1x1 prediction convs; always float32."""

    def __init__(self, nc: int, na: int, chs: Sequence[int]):
        super().__init__()
        self.nc, self.na, self.no = nc, na, nc + 5
        self.m = nn.ModuleList(nn.Conv2d(c, na * self.no, 1) for c in chs)

    def forward(self, xs):
        outs = []
        with torch.autocast(xs[0].device.type, enabled=False):
            for conv, x in zip(self.m, xs):
                y = conv(x.float())
                n, _, ny, nx = y.shape
                outs.append(y.view(n, self.na, self.no, ny, nx)
                            .permute(0, 3, 4, 1, 2).contiguous())
        return outs


class DetectionModel(nn.Module):
    """Executes a declarative layer spec (backbone + head).

    dtype: computation dtype of the conv stack (e.g. ``torch.bfloat16``),
    applied with autocast; parameters stay float32 and the Detect head
    always emits float32 logits.  None keeps float32 everywhere.
    """

    def __init__(self, spec=None, dtype=None):
        super().__init__()
        spec = spec or YOLOV3_SPEC
        self.spec, self.dtype = spec, dtype
        nc, na = spec["nc"], len(spec["anchors"][0]) // 2
        if (spec.get("depth_multiple", 1.0), spec.get("width_multiple", 1.0)
                ) != (1.0, 1.0):
            raise NotImplementedError("depth/width multiples are not ported")
        act = spec.get("activation") or True

        def rows(make, c1, c2, num):
            """A row repeated num times: make(c_in) per repeat."""
            if num == 1:
                return make(c1)
            return nn.Sequential(make(c1), *(make(c2) for _ in range(num - 1)))

        self.froms = []
        layers, ch = [], []
        for i, (frm, num, mod, args) in enumerate(flatten_layers(spec)):
            if isinstance(frm, int):
                c1 = 3 if (frm == -1 and i == 0) else ch[frm]
            if mod == "Conv":
                c2, k, s = args[0], args[1], args[2]
                p = args[3] if len(args) > 3 else None
                m = rows(lambda c, c2=c2, k=k, s=s, p=p:
                         ConvBNAct(c, c2, k, s, p, act), c1, c2, num)
            elif mod == "Bottleneck":
                c2 = args[0]
                sc = args[1] if len(args) > 1 else True
                m = rows(lambda c, c2=c2, sc=sc: Bottleneck(c, c2, sc, act=act),
                         c1, c2, num)
            elif mod == "Upsample":
                m, c2 = Upsample(), c1
            elif mod == "Concat":
                m, c2 = Concat(), sum(ch[j] for j in frm)
            elif mod == "MaxPool":
                m, c2 = MaxPool(args[0], args[1]), c1
            elif mod == "ZeroPad":
                m, c2 = ZeroPad(args[0]), c1
            elif mod == "Detect":
                m, c2 = Detect(nc, na, [ch[j] for j in frm]), None
            else:
                raise NotImplementedError(f"module {mod} is not ported")
            layers.append(m)
            ch.append(c2)
            self.froms.append(frm)
        self.model = nn.ModuleList(layers)

    def forward(self, x_nhwc):
        x = x_nhwc.permute(0, 3, 1, 2)
        ctx = (torch.autocast(x.device.type, dtype=self.dtype)
               if self.dtype is not None else contextlib.nullcontext())
        outputs: List = []
        with ctx:
            for frm, m in zip(self.froms, self.model):
                if isinstance(frm, int):
                    inp = x if frm == -1 else outputs[frm]
                else:
                    inp = [x if j == -1 else outputs[j] for j in frm]
                y = m(inp)
                outputs.append(y)
                if not isinstance(y, list):
                    x = y
        return outputs[-1]


def frozen(model: DetectionModel) -> DetectionModel:
    """The reward detector inside a differentiated graph: eval mode
    (BatchNorm on its running statistics) and no parameter gradients, so
    only the input image receives a gradient.  A ``dtype`` (bf16) runs
    under autocast in the forward, and autograd replays the same types in
    the backward."""
    model.eval()
    model.requires_grad_(False)
    return model


def model_strides(spec=None) -> Tuple[int, ...]:
    """Detection strides, traced statically through the layer spec."""
    spec = spec or YOLOV3_SPEC
    per_layer: List = []
    cur = 1
    for frm, num, mod, args in flatten_layers(spec):
        if isinstance(frm, int):
            s_in = cur if frm == -1 else per_layer[frm]
        else:
            s_in = [cur if j == -1 else per_layer[j] for j in frm]
        if mod == "Conv":
            s = s_in * args[2]
        elif mod == "Upsample":
            s = s_in // 2
        elif mod == "MaxPool":
            s = s_in * args[1]
        elif mod == "Concat":
            s = s_in[0]
        elif mod == "Detect":
            return tuple(int(v) for v in s_in)
        else:  # Bottleneck / ZeroPad: stride-neutral
            s = s_in
        per_layer.append(s)
        cur = s
    raise ValueError("spec has no Detect head")


def anchors_in_grid_units(spec=None) -> List[np.ndarray]:
    """Anchors divided by stride (the form the loss uses)."""
    spec = spec or YOLOV3_SPEC
    out = []
    for lvl, s in enumerate(model_strides(spec)):
        a = np.asarray(spec["anchors"][lvl], np.float32).reshape(-1, 2)
        out.append(a / s)
    return out


def decode_predictions(preds: Sequence[torch.Tensor], spec=None):
    """Raw per-level logits -> [N, total, no] pixel-space boxes:
    xy = (2*sig(txy) + grid - 0.5) * stride; wh = (2*sig(twh))^2 * anchor;
    conf/cls = sig."""
    spec = spec or YOLOV3_SPEC
    zs = []
    for lvl, (p, stride) in enumerate(zip(preds, model_strides(spec))):
        n, ny, nx, na, no = p.shape
        y = torch.sigmoid(p)
        gxv, gyv = np.meshgrid(np.arange(nx, dtype=np.float32),
                               np.arange(ny, dtype=np.float32))
        grid = torch.as_tensor(np.stack([gxv, gyv], axis=-1) - 0.5,
                               dtype=p.dtype, device=p.device)
        anchors_px = torch.as_tensor(
            np.asarray(spec["anchors"][lvl], np.float32).reshape(na, 2),
            dtype=p.dtype, device=p.device)
        xy = (y[..., 0:2] * 2 + grid[None, :, :, None, :]) * stride
        wh = (y[..., 2:4] * 2) ** 2 * anchors_px[None, None, None, :, :]
        z = torch.cat([xy, wh, y[..., 4:]], dim=-1)
        zs.append(z.reshape(n, ny * nx * na, no))
    return torch.cat(zs, dim=1)
