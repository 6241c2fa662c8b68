"""Hyperparameter surface: YAML loading, trainer scaling and genetic
evolution (port of ``adaptiveisp_tpu/detect/hyp.py``).

A hyp dict is flat ``{name: float}``: the scratch-low defaults overlaid
with a YAML file.  ``split_hyp`` maps it onto the three typed configs the
trainers take (``DetTrainConfig``, ``LossHyp``, ``AugHyp``) with the
reference's layer, class and image-size loss scaling.  ``evolve_detector``
is the reference's --evolve loop: fitness-weighted parent selection over
the best five generations and a clipped gaussian mutation, every draw from
one ``np.random.RandomState(seed)`` in the JAX package's order.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from adaptiveisp_tpu_torch.data.detector_dataset import AugHyp
from adaptiveisp_tpu_torch.detect.loss import LossHyp
from adaptiveisp_tpu_torch.detect.train_detector import DetTrainConfig

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

# evolution metadata: (mutation gain 0-1, lower limit, upper limit)
# (reference train.py:549-578)
HYP_META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1, 1e-5, 1e-1),
    "lrf": (1, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1, 0.0, 0.001),
    "warmup_epochs": (1, 0.0, 5.0),
    "warmup_momentum": (1, 0.0, 0.95),
    "warmup_bias_lr": (1, 0.0, 0.2),
    "box": (1, 0.02, 0.2),
    "cls": (1, 0.2, 4.0),
    "cls_pw": (1, 0.5, 2.0),
    "obj": (1, 0.2, 4.0),
    "obj_pw": (1, 0.5, 2.0),
    "iou_t": (0, 0.1, 0.7),
    "anchor_t": (1, 2.0, 8.0),
    "fl_gamma": (0, 0.0, 2.0),
    "label_smoothing": (0, 0.0, 0.1),
    "hsv_h": (1, 0.0, 0.1),
    "hsv_s": (1, 0.0, 0.9),
    "hsv_v": (1, 0.0, 0.9),
    "degrees": (1, 0.0, 45.0),
    "translate": (1, 0.0, 0.9),
    "scale": (1, 0.0, 0.9),
    "shear": (1, 0.0, 10.0),
    "perspective": (0, 0.0, 0.001),
    "flipud": (1, 0.0, 1.0),
    "fliplr": (0, 0.0, 1.0),
    "mosaic": (1, 0.0, 1.0),
    "mosaic9": (1, 0.0, 1.0),
    "mixup": (1, 0.0, 1.0),
    "copy_paste": (1, 0.0, 1.0),
}


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
    """Map a flat hyp dict onto (DetTrainConfig, LossHyp, AugHyp).

    With scale=True, applies the reference's layer/class/image-size loss
    scaling (train.py:140-148): box *= 3/nl, cls *= nc/80 * 3/nl,
    obj *= (imgsz/640)^2 * 3/nl.  Extra kwargs (epochs, batch_size,
    patience, ...) pass through to DetTrainConfig."""
    box, cls_, obj = hyp["box"], hyp["cls"], hyp["obj"]
    if scale:
        box *= 3.0 / nl
        cls_ *= nc / 80.0 * 3.0 / nl
        obj *= (imgsz / 640.0) ** 2 * 3.0 / nl

    cfg = DetTrainConfig(
        lr0=hyp["lr0"], lrf=hyp["lrf"], momentum=hyp["momentum"],
        weight_decay=hyp["weight_decay"],
        warmup_epochs=hyp["warmup_epochs"],
        warmup_momentum=hyp["warmup_momentum"],
        warmup_bias_lr=hyp["warmup_bias_lr"], **train_kwargs)
    loss_hyp = LossHyp(
        box=box, obj=obj, cls=cls_, cls_pw=hyp["cls_pw"],
        obj_pw=hyp["obj_pw"], anchor_t=hyp["anchor_t"],
        fl_gamma=hyp["fl_gamma"], label_smoothing=hyp["label_smoothing"])
    aug_hyp = AugHyp(
        hsv_h=hyp["hsv_h"], hsv_s=hyp["hsv_s"], hsv_v=hyp["hsv_v"],
        degrees=hyp["degrees"], translate=hyp["translate"],
        scale=hyp["scale"], shear=hyp["shear"],
        perspective=hyp["perspective"], flipud=hyp["flipud"],
        fliplr=hyp["fliplr"], mosaic=hyp["mosaic"],
        mosaic9=hyp["mosaic9"], mixup=hyp["mixup"],
        copy_paste=hyp["copy_paste"])
    return cfg, loss_hyp, aug_hyp


# --------------------------------------------------------------------------- #
# Evolution
# --------------------------------------------------------------------------- #
HYP_KEYS = list(DEFAULT_HYP)  # fixed column order for evolve.csv


def mutate_hyp(base: Dict[str, float], rng: np.random.RandomState,
               mp: float = 0.8, sigma: float = 0.2) -> Dict[str, float]:
    """One clipped-gaussian mutation of every evolvable hyp (reference
    train.py:581-593): multiply by factors in [0.3, 3], gain-weighted,
    re-drawn until at least one value changes, then constrain to the
    HYP_META limits and round to 5 significant decimals."""
    gains = np.array([HYP_META[k][0] for k in HYP_KEYS])
    ng = len(HYP_KEYS)
    v = np.ones(ng)
    while (v == 1).all():
        v = (gains * (rng.random_sample(ng) < mp) * rng.randn(ng)
             * rng.random_sample() * sigma + 1).clip(0.3, 3.0)
    out = {}
    for k, vi in zip(HYP_KEYS, v):
        _, lo, hi = HYP_META[k]
        out[k] = round(float(np.clip(base[k] * vi, lo, hi)), 5)
    return out


def select_parent(rows: List[Tuple[float, Dict[str, float]]],
                  rng: np.random.RandomState) -> Dict[str, float]:
    """Fitness-weighted single-parent selection over the top-5 prior
    generations (reference train.py:566-575)."""
    rows = sorted(rows, key=lambda r: -r[0])[:5]
    fits = np.array([r[0] for r in rows])
    w = fits - fits.min() + 1e-6
    i = rng.choice(len(rows), p=w / w.sum())
    return dict(rows[i][1])


def evolve_detector(build_and_fit: Callable[[Dict[str, float]], float],
                    generations: int = 10,
                    save_dir: str = ".",
                    base_hyp: Optional[Dict[str, float]] = None,
                    seed: int = 0, plot: bool = True) -> Dict:
    """The --evolve loop (reference train.py:598-645).

    build_and_fit(hyp) must train a fresh model with the given hyps and
    return its fitness (0.1*mAP50 + 0.9*mAP).  Each generation mutates a
    fitness-weighted parent, trains, and appends (fitness, hyps) to
    evolve.csv; the best hyps land in hyp_evolve.yaml and evolve.png
    (where matplotlib imports).
    """
    os.makedirs(save_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    evolve_csv = os.path.join(save_dir, "evolve.csv")
    history: List[Tuple[float, Dict[str, float]]] = []
    base = dict(DEFAULT_HYP)
    base.update(base_hyp or {})

    # resume: a pre-existing evolve.csv seeds the parent-selection history
    # (the reference re-reads evolve.csv each generation, train.py:528),
    # so an interrupted sweep continues instead of re-training gen 0 and
    # contradicting the rows it appends to
    if os.path.exists(evolve_csv):
        with open(evolve_csv) as f:
            rows = [ln.strip().split(",") for ln in f if ln.strip()]
        if rows and rows[0][0] == "fitness":
            keys = rows[0][1:]
            for r in rows[1:]:
                history.append((float(r[0]),
                                {k: float(v) for k, v in zip(keys, r[1:])}))
        if history:
            print(f"evolve: resuming with {len(history)} prior "
                  f"generations from {evolve_csv}")

    for gen in range(generations):
        if history:
            hyp = mutate_hyp(select_parent(history, rng), rng)
        else:
            hyp = dict(base)  # generation 0 = the unmutated base
        fit = float(build_and_fit(hyp))
        history.append((fit, hyp))
        new = not os.path.exists(evolve_csv)
        with open(evolve_csv, "a") as f:
            if new:
                f.write("fitness," + ",".join(HYP_KEYS) + "\n")
            f.write(f"{fit:.6g}," + ",".join(
                f"{hyp[k]:.6g}" for k in HYP_KEYS) + "\n")

    best_fit, best_hyp = max(history, key=lambda r: r[0])
    with open(os.path.join(save_dir, "hyp_evolve.yaml"), "w") as f:
        f.write(f"# fitness {best_fit:.5g} after {generations} "
                "generations\n")
        for k in HYP_KEYS:
            f.write(f"{k}: {best_hyp[k]}\n")
    if plot:
        from adaptiveisp_tpu_torch.obs.plots import (
            plot_evolve,
            plots_available,
        )

        if plots_available():
            plot_evolve(evolve_csv)
    return {"best_fitness": best_fit, "best_hyp": best_hyp,
            "history": history, "evolve_csv": evolve_csv}
