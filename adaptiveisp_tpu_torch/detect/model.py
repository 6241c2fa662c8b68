"""Spec-driven YOLO detection and segmentation model (port of
``adaptiveisp_tpu/detect/model.py``).

``DetectionModel`` builds the layer list of a spec as an ``nn.ModuleList``
named ``model`` (a row repeated n > 1 times is an ``nn.Sequential``), so the
state-dict keys are ultralytics' ``model.{i}.*`` / ``model.{i}.{r}.*``.  It
takes NHWC images, runs NCHW inside, and returns the raw per-level logits in
the JAX package's order [N, ny, nx, na, no] (not ultralytics'
[N, na, ny, nx, no]): candidate order feeds NMS top-k and its ties.  A
``Segment`` head returns ``(preds, proto)``: each level carries ``nm`` mask
coefficients after the class scores, and ``proto`` is the prototype masks
[N, mh, mw, nm] at twice the first level's resolution.
In train mode (``model.train()``) it returns the same raw per-level logits
with BatchNorm on the batch's statistics (flax's, see ``layers.py``): the
JAX model's ``train=True`` forward, which ``loss.batch_loss`` takes.
:func:`decode_predictions` turns them into pixel-space boxes.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from adaptiveisp_tpu_torch.detect.layers import (
    C3,
    SPP,
    SPPF,
    Bottleneck,
    BottleneckCSP,
    Concat,
    ConvBNAct,
    CrossConv,
    DWConv,
    Focus,
    GhostBottleneck,
    GhostConv,
    Lambda,
    MaxPool,
    Proto,
    Upsample,
    ZeroPad,
    contract,
    expand,
)
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC, flatten_layers
from adaptiveisp_tpu_torch.nn_init import flax_init_
from adaptiveisp_tpu_torch.obs.profile import count


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round channel counts up to the divisor."""
    return int(math.ceil(x / divisor) * divisor)


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


class SegmentHead(Detect):
    """Detect with ``nm`` mask coefficients per anchor and the Proto tower
    (child ``proto``) on the first input; returns ``(preds, proto)``, proto
    NHWC float32."""

    def __init__(self, nc: int, na: int, chs: Sequence[int], nm: int = 32,
                 npr: int = 256, act=True):
        super().__init__(nc + nm, na, chs)
        self.nc, self.nm = nc, nm
        self.proto = Proto(chs[0], npr, nm, act)

    def forward(self, xs):
        proto = self.proto(xs[0]).float().permute(0, 2, 3, 1).contiguous()
        return super().forward(xs), proto


def _arg(args, i, default):
    return args[i] if len(args) > i else default


class DetectionModel(nn.Module):
    """Executes a declarative layer spec (backbone + head).

    dtype: computation dtype of the conv stack (e.g. ``torch.bfloat16``),
    applied with autocast; parameters stay float32 and the Detect head
    always emits float32 logits.  None keeps float32 everywhere.  ``nc``
    overrides the spec's class count (the head's width only, as in the
    JAX model).  The spec's ``depth_multiple`` scales repeat counts and
    ``width_multiple`` channels (rounded up to a multiple of 8), and its
    ``activation`` replaces SiLU throughout.  Weights start from flax's
    initial distributions (``nn_init.flax_init_``).
    """

    def __init__(self, spec=None, dtype=None, nc: int | None = None):
        super().__init__()
        spec = spec or YOLOV3_SPEC
        self.spec, self.dtype = spec, dtype
        nc = spec["nc"] if nc is None else nc
        na = len(spec["anchors"][0]) // 2
        gd = float(spec.get("depth_multiple", 1.0))
        gw = float(spec.get("width_multiple", 1.0))
        act = spec.get("activation") or True

        def width(c):
            return c if gw == 1.0 else make_divisible(c * gw, 8)

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
            num = max(round(num * gd), 1) if num > 1 else num
            c2 = width(args[0]) if args and isinstance(args[0], int) else None
            if mod == "Conv":
                k, s, p = args[1], args[2], _arg(args, 3, None)
                m = rows(lambda c, k=k, s=s, p=p: ConvBNAct(c, c2, k, s, p,
                                                            act),
                         c1, c2, num)
            elif mod == "Bottleneck":
                sc = _arg(args, 1, True)
                m = rows(lambda c, sc=sc: Bottleneck(c, c2, sc, act=act),
                         c1, c2, num)
            elif mod in ("C3", "C3x", "C3TR", "C3Ghost"):
                # the row's repeat count is the inner block count
                variant = {"C3": "bottleneck", "C3x": "cross",
                           "C3TR": "transformer", "C3Ghost": "ghost"}[mod]
                m = C3(c1, c2, n=num, shortcut=_arg(args, 1, True), act=act,
                       variant=variant)
            elif mod == "BottleneckCSP":
                m = BottleneckCSP(c1, c2, n=num, shortcut=_arg(args, 1, True),
                                  act=act)
            elif mod == "C3SPP":
                # repeats the whole module, as JAX's DetectionModel does
                k = tuple(_arg(args, 1, (5, 9, 13)))
                m = rows(lambda c, k=k: C3(c, c2, variant="spp", k_spp=k,
                                           act=act), c1, c2, num)
            elif mod == "DWConv":
                k, s = _arg(args, 1, 1), _arg(args, 2, 1)
                m = rows(lambda c, k=k, s=s: DWConv(c, c2, k, s, act=act),
                         c1, c2, num)
            elif mod == "GhostConv":
                k, s = _arg(args, 1, 1), _arg(args, 2, 1)
                m = rows(lambda c, k=k, s=s: GhostConv(c, c2, k, s, act=act),
                         c1, c2, num)
            elif mod == "GhostBottleneck":
                k, s = _arg(args, 1, 3), _arg(args, 2, 1)
                m = rows(lambda c, k=k, s=s: GhostBottleneck(c, c2, k, s,
                                                             act=act),
                         c1, c2, num)
            elif mod == "CrossConv":
                k, s = _arg(args, 1, 3), _arg(args, 2, 1)
                e, sc = _arg(args, 4, 1.0), _arg(args, 5, False)
                m = rows(lambda c, k=k, s=s, e=e, sc=sc: CrossConv(
                    c, c2, k, s, e=e, shortcut=sc, act=act), c1, c2, num)
            elif mod == "Contract":
                g = args[0] if args else 2
                m, c2 = Lambda(contract, g), c1 * g * g
            elif mod == "Expand":
                g = args[0] if args else 2
                m, c2 = Lambda(expand, g), c1 // (g * g)
            elif mod == "SPP":
                m = SPP(c1, c2, k=tuple(_arg(args, 1, (5, 9, 13))), act=act)
            elif mod == "SPPF":
                m = SPPF(c1, c2, k=_arg(args, 1, 5), act=act)
            elif mod == "Focus":
                m = Focus(c1, c2, k=_arg(args, 1, 1), s=_arg(args, 2, 1),
                          act=act)
            elif mod == "Upsample":
                m, c2 = Upsample(), c1
            elif mod == "Concat":
                m, c2 = Concat(), sum(ch[j] for j in frm)
            elif mod == "MaxPool":
                m, c2 = MaxPool(args[0], args[1]), c1
            elif mod == "ZeroPad":
                m, c2 = ZeroPad(args[0]), c1
            elif mod == "Identity":
                m, c2 = nn.Identity(), c1
            elif mod == "Detect":
                m, c2 = Detect(nc, na, [ch[j] for j in frm]), None
            elif mod == "Segment":
                m, c2 = SegmentHead(nc, na, [ch[j] for j in frm],
                                    nm=_arg(args, 2, 32),
                                    npr=width(_arg(args, 3, 256)),
                                    act=act), None
            else:
                raise ValueError(f"Unknown module {mod}")
            layers.append(m)
            ch.append(c2)
            self.froms.append(frm)
        self.model = nn.ModuleList(layers)
        self.channels = ch  # each row's output channels (None: the head)
        flax_init_(self)

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
    """Detection strides, traced statically through the layer spec
    (Conv/Focus/MaxPool/Contract multiply, Upsample/Expand divide)."""
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
        elif mod in ("DWConv", "GhostConv", "GhostBottleneck", "CrossConv"):
            s = s_in * _arg(args, 2, 1)
        elif mod == "Focus":
            s = s_in * 2 * _arg(args, 2, 1)
        elif mod == "Contract":
            s = s_in * (args[0] if args else 2)
        elif mod == "Expand":
            s = s_in // (args[0] if args else 2)
        elif mod == "Upsample":
            s = s_in // 2
        elif mod == "MaxPool":
            s = s_in * args[1]
        elif mod == "Concat":
            s = s_in[0]
        elif mod in ("Detect", "Segment"):
            return tuple(int(v) for v in s_in)
        else:  # Bottleneck/C3 family/CSP/SPP(F)/ZeroPad/Identity: neutral
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
    nc = spec["nc"]
    zs = []
    for lvl, (p, stride) in enumerate(zip(preds, model_strides(spec))):
        n, ny, nx, na, no = p.shape
        # channels past 5 + spec nc (mask coefficients) stay raw, as JAX's
        y = torch.cat([torch.sigmoid(p[..., :5 + nc]), p[..., 5 + nc:]],
                      dim=-1)
        count("host_read.upload.detect", 2)  # the grid and the anchors
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


def initialize_detect_biases(state_dict, spec=None, imgsz: int = 640,
                             cf=None):
    """Focal-style prior of the Detect biases (JAX's
    ``initialize_detect_biases``) on a copy of the port's ``state_dict``:
    objectness + log(8 / (imgsz / stride)^2), classes + log(0.6 / (nc -
    0.99999)) or log(cf / cf.sum()) with class frequencies ``cf``."""
    spec = spec or YOLOV3_SPEC
    nc = spec["nc"]
    det = len(flatten_layers(spec)) - 1
    out = dict(state_dict)
    for i, s in enumerate(model_strides(spec)):
        key = f"model.{det}.m.{i}.bias"
        b = out[key].detach().cpu().double().numpy().reshape(
            len(spec["anchors"][i]) // 2, -1).copy()
        b[:, 4] += np.log(8 / (imgsz / s) ** 2)
        if cf is None:
            b[:, 5:5 + nc] += np.log(0.6 / (nc - 0.99999))
        else:
            cf = np.asarray(cf, np.float64)
            b[:, 5:5 + nc] += np.log(cf / cf.sum())
        out[key] = torch.as_tensor(b.reshape(-1), dtype=state_dict[key].dtype,
                                   device=state_dict[key].device)
    return out
