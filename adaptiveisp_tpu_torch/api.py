"""One-call entry points of the port (port of ``adaptiveisp_tpu/api.py``,
the torch-hub analog):

    from adaptiveisp_tpu_torch import api
    isp = api.load_adaptive_isp()              # seeded random weights, cuda
    out = isp.process(images_nhwc)             # 5-step adaptive ISP
    det = api.load_detector(weights="yolov3.pt")
    boxes, n = det.detect(out)
    res = api.yolov5s()(["a.jpg", pil_image, uint8_array])   # Detections
    critic = api.load_value()                  # the actor-critic's critic

``load_detector(weights=[a, b])`` is an NMS ensemble; ``yolov3`` ..
``yolov5x6`` and ``custom`` are the hub constructors.  The loaders run on
``cuda`` unless the caller passes ``device="cpu"``, and raise when CUDA is
asked for and absent.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from adaptiveisp_tpu_torch.config import DEFAULT_CONFIG, Config
from adaptiveisp_tpu_torch.data.dataset_config import COCO_NAMES
from adaptiveisp_tpu_torch.data.letterbox import letterbox
from adaptiveisp_tpu_torch.data.sources import load_image_file
from adaptiveisp_tpu_torch.detect.boxes import scale_boxes
from adaptiveisp_tpu_torch.detect.ensemble import DetectorEnsemble
from adaptiveisp_tpu_torch.detect.model import (
    DetectionModel,
    decode_predictions,
)
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC, resolve_spec
from adaptiveisp_tpu_torch.detect.tta import forward_augment
from adaptiveisp_tpu_torch.eval.rollout import (
    RolloutResult,
    ServedRollout,
    no_pipeline,
    upload,
)
from adaptiveisp_tpu_torch.obs.profile import span
from adaptiveisp_tpu_torch.policy.agent import Agent
from adaptiveisp_tpu_torch.policy.states import get_noise
from adaptiveisp_tpu_torch.policy.value import Value


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent, so a run never falls back to the CPU unless the caller says so
    (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def _seeded(seed: int, build):
    """Build a module with the CPU generator seeded, without disturbing the
    caller's random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _as_images(images, device) -> torch.Tensor:
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.asarray(images, np.float32))
    return images.to(device=device, dtype=torch.float32)


@dataclasses.dataclass
class AdaptiveISP:
    """Loaded agent + rollout."""

    cfg: Config
    agent: Any
    device: torch.device
    steps: int = 5

    def __post_init__(self):
        self._rng = np.random.RandomState(0)
        self._served = ServedRollout()

    def _noises(self, n, seed):
        """The steps' noise drawn on the host, on the device without a
        wait for the stream."""
        rng = np.random.RandomState(seed) if seed is not None else self._rng
        noises = np.stack([get_noise(rng, n, self.cfg.z_dim, self.cfg.z_type)
                           for _ in range(self.steps)])
        return upload(torch.from_numpy(noises), self.device)

    def process_with_trace(self, images,
                           pipeline: Optional[Sequence[int]] = None,
                           seed: Optional[int] = None,
                           record_steps: bool = True) -> RolloutResult:
        """Full rollout record; ``pipeline`` holds one forced filter id per
        step (None or -1 for the agent's choice).  Without recorded steps,
        a CUDA batch of a shape seen before replays a CUDA graph
        (``eval.rollout.ServedRollout``)."""
        images = _as_images(images, self.device)
        noises = self._noises(images.shape[0], seed)
        pipe = (no_pipeline(self.steps) if pipeline is None
                else [-1 if p is None else int(p) for p in pipeline])
        return self._served(self.agent, images, noises, pipe,
                            record_steps=record_steps)

    def process(self, images, pipeline: Optional[Sequence[int]] = None,
                seed: Optional[int] = None):
        """images [N, H, W, 3] float32 in [0, 1] -> retouched images."""
        return self.process_with_trace(images, pipeline, seed,
                                       record_steps=False).image


class Detections:
    """Inference results: per-image boxes in the ORIGINAL image's pixels,
    with ``render`` / ``save`` / ``crop`` / ``to_dicts`` (the reference
    hub's Detections)."""

    def __init__(self, ims, xyxy, names, paths=None):
        self.ims = ims            # list of HWC float32 [0, 1] originals
        self.xyxy = xyxy          # list of [n, 6] (xyxy, conf, cls)
        self.names = names        # {class_id: name}
        self.paths = paths or [None] * len(ims)

    def __len__(self):
        return len(self.ims)

    def __repr__(self):
        lines = []
        for i, det in enumerate(self.xyxy):
            h, w = self.ims[i].shape[:2]
            counts = {}
            for c in det[:, 5].astype(int):
                counts[c] = counts.get(c, 0) + 1
            body = ", ".join(
                f"{n} {self.names.get(c, c)}{'s' if n > 1 else ''}"
                for c, n in sorted(counts.items())) or "(no detections)"
            lines.append(f"image {i}/{len(self)}: {w}x{h} {body}")
        return "\n".join(lines)

    def to_dicts(self):
        """Per-image list of detection dicts."""
        return [[{"xmin": float(d[0]), "ymin": float(d[1]),
                  "xmax": float(d[2]), "ymax": float(d[3]),
                  "confidence": float(d[4]), "class": int(d[5]),
                  "name": self.names.get(int(d[5]), str(int(d[5])))}
                 for d in det] for det in self.xyxy]

    def render(self):
        """Boxes drawn onto copies of the originals; uint8 images."""
        from PIL import Image, ImageDraw

        rendered = []
        for im, det in zip(self.ims, self.xyxy):
            pil = Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8))
            draw = ImageDraw.Draw(pil)
            for d in det:
                c = int(d[5])
                color = (37 * (c + 1) % 256, 91 * (c + 3) % 256,
                         53 * (c + 7) % 256)
                draw.rectangle(list(map(float, d[:4])), outline=color,
                               width=2)
                draw.text((float(d[0]) + 2, float(d[1]) + 2),
                          f"{self.names.get(c, c)} {d[4]:.2f}", fill=color)
            rendered.append(np.asarray(pil))
        return rendered

    def save(self, save_dir: str = "runs/hub"):
        from PIL import Image

        os.makedirs(save_dir, exist_ok=True)
        outs = []
        for i, arr in enumerate(self.render()):
            name = (f"image{i}.png" if self.paths[i] is None else
                    os.path.split(self.paths[i])[1])
            p = os.path.join(save_dir, name)
            Image.fromarray(arr).save(p)
            outs.append(p)
        return outs

    def crop(self, save_dir: Optional[str] = None):
        """Per-detection crops ({im, cls, conf}), saved as PNGs when
        ``save_dir`` is given."""
        crops = []
        for im, det in zip(self.ims, self.xyxy):
            h, w = im.shape[:2]
            for d in det:
                x1, y1 = max(0, int(d[0])), max(0, int(d[1]))
                x2, y2 = min(w, int(np.ceil(d[2]))), min(h, int(np.ceil(d[3])))
                crops.append({"im": im[y1:y2, x1:x2].copy(),
                              "cls": int(d[5]), "conf": float(d[4])})
        if save_dir is not None:
            from PIL import Image

            os.makedirs(save_dir, exist_ok=True)
            for i, c in enumerate(crops):
                Image.fromarray(
                    (np.clip(c["im"], 0, 1) * 255).astype(np.uint8)).save(
                    os.path.join(save_dir, f"crop{i}_cls{c['cls']}.png"))
        return crops


def _source_image(s):
    """(HWC float32 [0, 1] image, path or None) of a path, a PIL image, a
    uint8 or a float array."""
    if isinstance(s, (str, os.PathLike)):
        return load_image_file(str(s)), str(s)
    if hasattr(s, "convert"):  # PIL image
        return np.asarray(s.convert("RGB"), np.float32) / 255.0, None
    s = np.asarray(s)
    if s.dtype == np.uint8:
        s = s.astype(np.float32) / 255.0
    return s, None


@dataclasses.dataclass
class Detector:
    """A detection model (or a :class:`DetectorEnsemble`) and its spec on
    ``device``; ``augment`` runs test-time augmentation (three passes)."""

    model: Any
    spec: Any
    device: torch.device
    names: Any = None
    augment: bool = False

    def __post_init__(self):
        if isinstance(self.model, DetectorEnsemble) and self.augment:
            raise ValueError("augment=True (TTA) is not supported for NMS "
                             "ensembles; run TTA per member instead")
        if self.names is None:
            self.names = dict(enumerate(COCO_NAMES))

    def decoded(self, images: torch.Tensor) -> torch.Tensor:
        """NHWC images on the device -> decoded candidates [N, M, no]
        (spans ``detect.forward``, ``detect.decode``)."""
        with span("detect.forward"):
            if isinstance(self.model, DetectorEnsemble):
                return self.model.decoded(images)
            if self.augment:
                return forward_augment(self.model, images, self.spec)
            raw = self.model(images)
        with span("detect.decode"):
            return decode_predictions(raw, self.spec)

    @torch.no_grad()
    def detect(self, images, conf_thres: float = 0.25,
               iou_thres: float = 0.45, max_det: int = 300,
               multi_label: bool = False, classes=None,
               agnostic: bool = False):
        """images [N, H, W, 3] -> (detections [N, max_det, 6], n_valid [N])
        (span ``detect``, NMS in ``detect.nms``)."""
        with span("detect"):
            preds = self.decoded(_as_images(images, self.device))
            with span("detect.nms"):
                return non_max_suppression(
                    preds, conf_thres=conf_thres, iou_thres=iou_thres,
                    max_det=max_det, multi_label=multi_label,
                    classes=tuple(classes) if classes is not None else None,
                    agnostic=agnostic)

    def __call__(self, sources, size: int = 512, conf_thres: float = 0.25,
                 iou_thres: float = 0.45, max_det: int = 300,
                 multi_label: bool = False, classes=None,
                 agnostic: bool = False) -> Detections:
        """A path, a PIL image, a uint8 or float HWC array, or a list of
        them: letterboxed to ``size`` (black borders), detected in one
        batch, boxes scaled back to each original."""
        if not isinstance(sources, (list, tuple)):
            sources = [sources]
        ims, paths = zip(*(_source_image(s) for s in sources))
        batch, metas = [], []
        for im in ims:
            lb, ratio, pad = letterbox(im, size, color=(0, 0, 0))
            batch.append(lb)
            metas.append((im.shape[:2], (ratio, pad)))
        dets, nvalid = self.detect(
            np.stack(batch, 0), conf_thres=conf_thres, iou_thres=iou_thres,
            max_det=max_det, multi_label=multi_label, classes=classes,
            agnostic=agnostic)
        dets, nvalid = dets.cpu().numpy(), nvalid.cpu().numpy()
        per_image = []
        for i, ((h0, w0), ratio_pad) in enumerate(metas):
            d = dets[i][:int(nvalid[i])].copy()
            if d.shape[0]:
                d[:, :4] = scale_boxes((size, size), d[:, :4], (h0, w0),
                                       ratio_pad)
            per_image.append(d)
        return Detections(list(ims), per_image, self.names, list(paths))


def _check_imgsz(imgsz):
    """JAX's loaders take the image size to build their variables; a torch
    module needs no shape, so the port only checks it."""
    if isinstance(imgsz, bool) or not isinstance(imgsz, int) or imgsz <= 0:
        raise ValueError(f"imgsz must be a positive int, got {imgsz!r}")


def load_adaptive_isp(agent_ckpt: Optional[str] = None,
                      cfg: Config = DEFAULT_CONFIG, imgsz: int = 512,
                      steps: int = 5, seed: int = 0, *, device="cuda",
                      state_dict: Optional[Mapping] = None) -> AdaptiveISP:
    """The agent in eval mode on ``device``: seeded random weights, or
    ``agent_ckpt`` (a checkpoint directory, the port's weights-only file or
    the JAX package's weights-only pickle, through
    ``train.checkpoint.load_agent_weights``), or ``state_dict`` (e.g. from
    ``convert.agent_from_flax``).  The positional order is JAX's;
    ``imgsz`` is checked and otherwise unused."""
    _check_imgsz(imgsz)
    dev = resolve_device(device)
    agent = _seeded(seed, lambda: Agent(cfg))
    if agent_ckpt:
        from adaptiveisp_tpu_torch.train.checkpoint import load_agent_weights

        state_dict = load_agent_weights(str(agent_ckpt), cfg)
    if state_dict is not None:
        agent.load_state_dict(state_dict)
    return AdaptiveISP(cfg, agent.to(dev).eval(), dev, steps=steps)


def _build_detector(weights, spec, nc, seed, dtype, state_dict):
    """One seeded DetectionModel with ``weights`` (a file or an artifact
    name; missing: seeded weights) or ``state_dict`` loaded."""
    model = _seeded(seed, lambda: DetectionModel(spec, dtype=dtype, nc=nc))
    if weights:
        from adaptiveisp_tpu_torch.train_isp import load_yolo_weights

        loaded = load_yolo_weights(str(weights), spec)
        state_dict = loaded if loaded is not None else state_dict
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def load_detector(weights=None, spec=None, nc: Optional[int] = None,
                  seed: int = 0, names=None, augment: bool = False,
                  device="cuda", state_dict: Optional[Mapping] = None,
                  dtype=None) -> Detector:
    """A :class:`Detector` in eval mode on ``device`` (default YOLOv3):
    seeded random weights, ``weights`` (a ``.pt`` / ``.pkl`` file or a
    local artifact name, through ``train_isp.load_yolo_weights``), or
    ``state_dict`` (e.g. from ``convert.yolo_from_flax``).  A list of
    weights is an NMS ensemble whose candidates are merged before one NMS;
    ``spec`` may then be one spec per member or one for all.  ``dtype``
    (e.g. ``torch.bfloat16``) is the conv stack's autocast type; ``nc``
    overrides the spec's class count."""
    dev = resolve_device(device)
    if isinstance(weights, (list, tuple)) and len(weights) > 1:
        specs = (list(spec) if isinstance(spec, (list, tuple))
                 else [spec] * len(weights))
        if len(specs) != len(weights):
            raise ValueError(f"{len(weights)} weights but {len(specs)} specs")
        specs = [s or YOLOV3_SPEC for s in specs]
        ens = DetectorEnsemble([
            (_build_detector(w, s, nc, seed, dtype, None), s)
            for w, s in zip(weights, specs)])
        return Detector(ens.to(dev).eval(), specs[0], dev, names=names,
                        augment=augment)
    if isinstance(weights, (list, tuple)):
        weights = weights[0] if weights else None
    spec = spec or YOLOV3_SPEC
    model = _build_detector(weights, spec, nc, seed, dtype, state_dict)
    return Detector(model.to(dev).eval(), spec, dev, names=names,
                    augment=augment)

def load_value(cfg: Config = DEFAULT_CONFIG, imgsz: int = 512, seed: int = 0,
               *, device="cuda", state_dict: Optional[Mapping] = None
               ) -> Value:
    """The critic with seeded random weights or ``state_dict`` (e.g. from
    ``convert.value_from_flax``), in eval mode on ``device``.  The
    positional order is JAX's; ``imgsz`` is checked and otherwise unused."""
    _check_imgsz(imgsz)
    dev = resolve_device(device)
    value = _seeded(seed, lambda: Value(cfg))
    if state_dict is not None:
        value.load_state_dict(state_dict)
    return value.to(dev).eval()


# --------------------------------------------------------------------------- #
# hub constructors: each a one-call Detector over a named spec; `custom`
# loads any weights file with an optional spec.
# --------------------------------------------------------------------------- #
def _named(spec_name, weights=None, classes: int = 80, **kw) -> Detector:
    spec = resolve_spec(spec_name)
    nc = None if classes == spec["nc"] else classes
    return load_detector(weights=weights, spec=spec, nc=nc, **kw)


def yolov3(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov3", weights, classes, **kw)


def yolov3_tiny(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov3-tiny", weights, classes, **kw)


def yolov3_spp(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov3-spp", weights, classes, **kw)


def yolov5n(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5n", weights, classes, **kw)


def yolov5s(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5s", weights, classes, **kw)


def yolov5m(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5m", weights, classes, **kw)


def yolov5l(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5l", weights, classes, **kw)


def yolov5x(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5x", weights, classes, **kw)


def yolov5n6(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5n6", weights, classes, **kw)


def yolov5s6(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5s6", weights, classes, **kw)


def yolov5m6(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5m6", weights, classes, **kw)


def yolov5l6(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5l6", weights, classes, **kw)


def yolov5x6(weights=None, classes: int = 80, **kw) -> Detector:
    return _named("yolov5x6", weights, classes, **kw)


def custom(path, spec=None, **kw) -> Detector:
    """Any weights file with an optional spec."""
    return load_detector(weights=path, spec=spec, **kw)
