"""Loss hyperparameters from a hyp YAML (port of ``load_hyp`` and
``split_hyp`` of ``adaptiveisp_tpu/detect/hyp.py``; evolution comes with
detector training).

A hyp dict is flat ``{name: float}``: the scratch-low defaults overlaid
with a YAML file.  ``split_hyp`` maps it onto the loss's
:class:`~adaptiveisp_tpu_torch.detect.loss.LossHyp` with the trainer's
layer, class and image-size scaling; the optimizer and augmentation values
come back as plain dicts.
"""

from __future__ import annotations

from typing import Dict, Optional

from adaptiveisp_tpu_torch.detect.loss import LossHyp

# hyp.scratch-low.yaml values, the defaults the reference trains with
DEFAULT_HYP: Dict[str, float] = {
    "lr0": 0.01,
    "lrf": 0.01,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 0.05,
    "cls": 0.5,
    "cls_pw": 1.0,
    "obj": 1.0,
    "obj_pw": 1.0,
    "iou_t": 0.20,
    "anchor_t": 4.0,
    "fl_gamma": 0.0,
    "label_smoothing": 0.0,
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mosaic9": 0.0,       # this framework's 9-image mosaic probability
    "mixup": 0.0,
    "copy_paste": 0.0,
}

TRAIN_KEYS = ("lr0", "lrf", "momentum", "weight_decay", "warmup_epochs",
              "warmup_momentum", "warmup_bias_lr")
AUG_KEYS = ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale",
            "shear", "perspective", "flipud", "fliplr", "mosaic", "mosaic9",
            "mixup", "copy_paste")


def load_hyp(path: Optional[str] = None) -> Dict[str, float]:
    """Hyp dict = defaults overlaid with a YAML file (reference
    train.py:96-101).  Unknown keys raise — a typo'd sweep should fail
    loudly, not silently no-op."""
    hyp = dict(DEFAULT_HYP)
    if path:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        unknown = [k for k in loaded if k not in DEFAULT_HYP
                   and k != "anchors"]
        if unknown:
            raise KeyError(f"unknown hyp keys in {path}: {unknown}")
        if "anchors" in loaded and loaded["anchors"]:
            # the reference's `anchors: N` re-parameterizes the head with
            # N autoanchor-fit anchors per level (train.py:160); here the
            # anchor count is part of the model SPEC — fail loudly rather
            # than silently no-op
            raise KeyError(
                "hyp 'anchors' is not supported: set the anchor count in "
                "the model spec / --spec YAML (AutoAnchor refits values "
                "in-loop)")
        hyp.update({k: float(v) for k, v in loaded.items()
                    if k in DEFAULT_HYP})
    return hyp


def split_hyp(hyp: Dict[str, float], nl: int = 3, nc: int = 80,
              imgsz: int = 640, scale: bool = True, **train_kwargs):
    """Map a flat hyp dict onto (train dict, LossHyp, augmentation dict).

    With scale=True, applies the reference's layer/class/image-size loss
    scaling: box *= 3/nl, cls *= nc/80 * 3/nl, obj *= (imgsz/640)^2 * 3/nl.
    Extra kwargs (epochs, batch_size, ...) join the train dict."""
    box, cls_, obj = hyp["box"], hyp["cls"], hyp["obj"]
    if scale:
        box *= 3.0 / nl
        cls_ *= nc / 80.0 * 3.0 / nl
        obj *= (imgsz / 640.0) ** 2 * 3.0 / nl
    train = {k: hyp[k] for k in TRAIN_KEYS}
    train.update(train_kwargs)
    loss_hyp = LossHyp(
        box=box, obj=obj, cls=cls_, cls_pw=hyp["cls_pw"],
        obj_pw=hyp["obj_pw"], anchor_t=hyp["anchor_t"],
        fl_gamma=hyp["fl_gamma"], label_smoothing=hyp["label_smoothing"])
    return train, loss_hyp, {k: hyp[k] for k in AUG_KEYS}
