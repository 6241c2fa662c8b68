"""Training and evaluation plots (port of ``adaptiveisp_tpu/obs/plots.py``):
train-batch mosaics with drawn boxes (``plot_images``, PIL only) and with
instance masks blended in (``plot_images_and_masks``), the label
distribution (``plot_labels``), results.csv curves (``plot_results``), the
hyperparameter-evolution scatter (``plot_evolve``), metric-vs-confidence
curves (``plot_mc_curve``), the speed-vs-mAP study (``plot_val_study``) and
per-stage feature maps (``capture_features`` with forward hooks, then
``feature_visualization``).  Images are NHWC float in [0, 1].  matplotlib is
imported when a curve plot is drawn.
"""

from __future__ import annotations

import colorsys
import csv
import glob
import math
import os
from typing import Optional, Sequence

import numpy as np


def plots_available() -> bool:
    """matplotlib draws the curve plots; where it does not import, only the
    PIL plots (train-batch mosaics) are written."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def class_color(i: int):
    """Deterministic per-class RGB (0-255 ints), golden-ratio hue walk."""
    h = (i * 0.618033988749895) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.75, 0.95)
    return int(r * 255), int(g * 255), int(b * 255)


def _to_uint8(im: np.ndarray) -> np.ndarray:
    im = np.asarray(im)
    if im.dtype != np.uint8:
        if im.max() <= 1.0 + 1e-3:
            im = im * 255.0
        im = np.clip(im, 0, 255).astype(np.uint8)
    return im


def plot_images(images, targets, paths: Optional[Sequence[str]] = None,
                fname: str = "images.jpg", names=None,
                max_subplots: int = 16, max_size: int = 1920) -> str:
    """Square mosaic of a batch with drawn (and labeled) boxes.

    images: [N, H, W, 3] float [0,1]; targets: flat [n, 6] label rows
    (img_idx, cls, xywh normalized) or [n, 7] prediction rows with a
    trailing confidence (conf <= 0.25 rows are skipped, reference
    plots.py:160).  Reference plot_images (plots.py:115-170).
    """
    from PIL import Image, ImageDraw

    images = _to_uint8(images)
    targets = np.asarray(targets, np.float32)
    if targets.size == 0:
        targets = targets.reshape(0, 6)
    bs, h, w = images.shape[:3]
    bs = min(bs, max_subplots)
    ns = int(math.ceil(bs ** 0.5))

    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        x, y = w * (i // ns), h * (i % ns)
        mosaic[y:y + h, x:x + w] = images[i]

    scale = max_size / ns / max(h, w)
    if scale < 1:
        h2, w2 = int(math.ceil(scale * h)), int(math.ceil(scale * w))
        img = Image.fromarray(mosaic).resize((w2 * ns, h2 * ns))
        h, w = h2, w2
    else:
        img = Image.fromarray(mosaic)
    draw = ImageDraw.Draw(img)

    has_conf = targets.shape[1] >= 7
    for i in range(bs):
        x, y = w * (i // ns), h * (i % ns)
        draw.rectangle([x, y, x + w - 1, y + h - 1],
                       outline=(255, 255, 255), width=2)
        if paths is not None and i < len(paths):
            draw.text((x + 5, y + 5), os.path.basename(str(paths[i]))[:40],
                      fill=(220, 220, 220))
        ti = targets[targets[:, 0] == i]
        for row in ti:
            cls = int(row[1])
            conf = row[6] if has_conf else None
            if conf is not None and conf <= 0.25:
                continue
            cx, cy, bw, bh = row[2:6]
            if max(cx, cy, bw, bh) <= 1.01:  # normalized
                cx, bw = cx * w, bw * w
                cy, bh = cy * h, bh * h
            elif scale < 1:
                cx, cy, bw, bh = (v * scale for v in (cx, cy, bw, bh))
            box = [x + cx - bw / 2, y + cy - bh / 2,
                   x + cx + bw / 2, y + cy + bh / 2]
            color = class_color(cls)
            draw.rectangle(box, outline=color, width=2)
            label = (names.get(cls, str(cls)) if isinstance(names, dict)
                     else (names[cls] if names and cls < len(names)
                           else str(cls)))
            if conf is not None:
                label = f"{label} {conf:.1f}"
            draw.text((box[0] + 2, max(box[1] - 10, y)), label, fill=color)
    img.save(fname)
    return fname


def overlay_masks(images, masks, classes=None, tmask=None,
                  alpha: float = 0.4) -> np.ndarray:
    """Alpha-blend per-instance masks into a batch of images.

    images [N,H,W,3] float [0,1] or uint8; masks [N,T,mh,mw] padded
    per-instance binary masks (nearest-upsampled to H,W); classes [N,T] int
    for per-class colors (instance index when absent); tmask [N,T] bool
    validity.  Returns a blended uint8 copy (reference
    utils/segment/plots.py plot_images_and_masks).
    """
    im = _to_uint8(images).copy()
    masks = np.asarray(masks)
    n, h, w = im.shape[:3]
    if masks.size == 0:
        return im
    mh, mw = masks.shape[2:]
    yi = (np.arange(h) * mh) // h
    xi = (np.arange(w) * mw) // w
    for i in range(n):
        for t in range(masks.shape[1]):
            if tmask is not None and not tmask[i][t]:
                continue
            m = masks[i, t][np.ix_(yi, xi)] > 0.5
            if not m.any():
                continue
            cls = int(classes[i][t]) if classes is not None else t
            color = np.asarray(class_color(cls), np.float32)
            im[i][m] = (im[i][m] * (1 - alpha)
                        + color * alpha).astype(np.uint8)
    return im


def plot_images_and_masks(images, targets, masks, tmask=None,
                          paths=None, fname: str = "images.jpg",
                          names=None, max_subplots: int = 16) -> str:
    """plot_images with instance masks blended in (the segmentation
    trainer's train-batch mosaic).

    targets: flat [n, >=6] rows (img_idx, cls, xywhn, ...); masks
    [N,T,mh,mw] aligned with each image's target order; tmask [N,T] marks
    valid instances.
    """
    targets = np.asarray(targets, np.float32)
    if targets.size == 0:
        targets = targets.reshape(0, 6)
    masks = np.asarray(masks)
    t_cap = masks.shape[1] if masks.size else 0
    classes = []
    for i in range(np.asarray(images).shape[0]):
        cls_i = targets[targets[:, 0] == i][:, 1].astype(int)
        classes.append(list(cls_i[:t_cap])
                       + [0] * max(0, t_cap - len(cls_i)))
    blended = overlay_masks(images, masks, classes=classes, tmask=tmask)
    return plot_images(blended, targets, paths=paths, fname=fname,
                       names=names, max_subplots=max_subplots)


def plot_labels(labels: np.ndarray, names=(), save_dir: str = ".") -> str:
    """Label-distribution panel: class histogram, box-overlay plot, x/y and
    w/h 2-D histograms (reference plot_labels, plots.py:272-310, minus the
    seaborn correlogram).  labels: [n, 5] (cls, xywh normalized)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image, ImageDraw

    labels = np.asarray(labels, np.float32)
    c = labels[:, 0].astype(int)
    b = labels[:, 1:5]
    nc = int(c.max()) + 1 if len(c) else 1

    fig, ax = plt.subplots(2, 2, figsize=(8, 8), tight_layout=True)
    ax = ax.ravel()
    y = ax[0].hist(c, bins=np.linspace(0, nc, nc + 1) - 0.5, rwidth=0.8)
    for i in range(nc):
        if i < len(y[2].patches):
            y[2].patches[i].set_color(
                tuple(v / 255 for v in class_color(i)))
    ax[0].set_ylabel("instances")
    if 0 < len(names) < 30:
        ax[0].set_xticks(range(len(names)))
        labels_txt = (list(names.values()) if isinstance(names, dict)
                      else list(names))
        ax[0].set_xticklabels(labels_txt, rotation=90, fontsize=10)
    else:
        ax[0].set_xlabel("classes")

    # centered rectangles overlay (first 1000 boxes)
    im = Image.new("RGB", (2000, 2000), (255, 255, 255))
    d = ImageDraw.Draw(im)
    for cls, (_, _, bw, bh) in zip(c[:1000], b[:1000]):
        x1 = (0.5 - bw / 2) * 2000
        y1 = (0.5 - bh / 2) * 2000
        x2 = (0.5 + bw / 2) * 2000
        y2 = (0.5 + bh / 2) * 2000
        d.rectangle([x1, y1, x2, y2], outline=class_color(int(cls)), width=1)
    ax[1].imshow(np.asarray(im))
    ax[1].axis("off")

    if len(b):
        ax[2].hist2d(b[:, 0], b[:, 1], bins=50, cmap="Blues")
        ax[3].hist2d(b[:, 2], b[:, 3], bins=50, cmap="Blues")
    ax[2].set_xlabel("x")
    ax[2].set_ylabel("y")
    ax[3].set_xlabel("width")
    ax[3].set_ylabel("height")

    out = os.path.join(save_dir, "labels.jpg")
    fig.savefig(out, dpi=200)
    plt.close(fig)
    return out


def _read_csv(path: str):
    with open(path) as f:
        rows = list(csv.reader(f))
    header = [h.strip() for h in rows[0]]
    data = np.array([[float(v) if v not in ("", "nan") else np.nan
                      for v in r] for r in rows[1:]], np.float64)
    return header, data


def _gauss_smooth(y: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    r = int(4 * sigma)
    xs = np.arange(-r, r + 1)
    k = np.exp(-xs ** 2 / (2 * sigma ** 2))
    k /= k.sum()
    yp = np.concatenate(([y[0]] * r, y, [y[-1]] * r))
    return np.convolve(yp, k, mode="valid")


def plot_results(file: str, save_path: Optional[str] = None) -> str:
    """Curves for every numeric column of a trainer results.csv, with a
    gaussian-smoothed overlay (reference plot_results, plots.py:373-400 —
    column layout is this trainer's, not ultralytics')."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    header, data = _read_csv(file)
    x = data[:, 0]  # epoch
    cols = [(i, name) for i, name in enumerate(header)
            if i > 0 and name != "seconds"]
    n = len(cols)
    ncols = min(5, max(1, n))
    nrows = int(math.ceil(n / ncols))
    fig, ax = plt.subplots(nrows, ncols, figsize=(2.6 * ncols, 2.8 * nrows),
                           tight_layout=True, squeeze=False)
    ax = ax.ravel()
    for k, (j, name) in enumerate(cols):
        y = data[:, j]
        ax[k].plot(x, y, marker=".", linewidth=2, markersize=6,
                   label="results")
        if len(y) > 5:
            ax[k].plot(x, _gauss_smooth(y), ":", linewidth=2,
                       label="smooth")
        ax[k].set_title(name, fontsize=11)
    for k in range(n, len(ax)):
        ax[k].axis("off")
    if n > 1:
        ax[1].legend(fontsize="small")
    save_path = save_path or os.path.join(os.path.dirname(file),
                                          "results.png")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_mc_curve(px, py, save_path: str, names=(),
                  xlabel: str = "Confidence",
                  ylabel: str = "Metric") -> str:
    """Metric-vs-confidence curve, per class plus the smoothed class mean.
    py: [nc, n_grid]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from adaptiveisp_tpu_torch.detect.metrics import smooth

    px = np.asarray(px)
    py = np.asarray(py)
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            label = (names[i] if i < len(names) else str(i))
            ax.plot(px, y, linewidth=1, label=f"{label}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    if py.shape[0]:
        y = smooth(py.mean(0), 0.05)
        ax.plot(px, y, linewidth=3, color="blue",
                label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize="small")
    ax.set_title(f"{ylabel}-Confidence Curve")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_evolve(evolve_csv: str, save_path: Optional[str] = None) -> str:
    """Hyperparameter-evolution scatter: fitness vs each mutated hyp, best
    point marked (reference plot_evolve, plots.py:346-370)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    header, data = _read_csv(evolve_csv)
    # column 0..: fitness first, then hyps (this framework's evolve.csv)
    fit = data[:, 0]
    j_best = int(np.nanargmax(fit))
    hyps = header[1:]
    n = len(hyps)
    ncols = min(5, max(1, n))
    nrows = int(math.ceil(n / ncols))
    fig, ax = plt.subplots(nrows, ncols, figsize=(2.5 * ncols, 2.5 * nrows),
                           tight_layout=True, squeeze=False)
    ax = ax.ravel()
    for k, name in enumerate(hyps):
        v = data[:, k + 1]
        ax[k].scatter(v, fit, c=fit, cmap="viridis", alpha=0.8,
                      edgecolors="none")
        ax[k].scatter(v[j_best], fit[j_best], marker="+", color="k", s=150)
        ax[k].set_title(f"{name} = {v[j_best]:.3g}", fontsize=9)
    for k in range(n, len(ax)):
        ax[k].axis("off")
    save_path = save_path or os.path.join(os.path.dirname(evolve_csv),
                                          "evolve.png")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_val_study(dir: str = ".", save_path: Optional[str] = None) -> str:
    """Speed-vs-mAP study curves from ``study_*.txt`` files (reference
    plot_val_study, plots.py:226-268).

    Each file holds one row per image size with columns
    ``P R mAP50 mAP50-95 t_pre t_inf t_nms wall_ms`` (the layout
    ``val_isp --task study`` writes).  One curve per file: latency (ms per
    image) on x, mAP50-95 (%) on y, up to each curve's best point.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(8, 4), tight_layout=True)
    for f in sorted(glob.glob(os.path.join(dir, "study*.txt"))):
        y = np.loadtxt(f, dtype=np.float32, ndmin=2).T
        if y.shape[0] < 6:
            continue
        j = int(y[3].argmax()) + 1
        label = os.path.splitext(os.path.basename(f))[0].replace(
            "study_", "")
        ax.plot(y[5, :j], y[3, :j] * 100.0, ".-", linewidth=2,
                markersize=8, label=label)
    ax.grid(alpha=0.2)
    ax.set_xlabel("inference latency (ms/img)")
    ax.set_ylabel("mAP50-95 (%)")
    ax.legend(fontsize=8)
    save_path = save_path or os.path.join(dir, "study.png")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def capture_features(model, x) -> dict:
    """Each stage's output of a ``DetectionModel`` forward of ``x`` (NHWC),
    named as flax's ``capture_intermediates`` names the JAX model's
    modules: ``l{i}``, or ``l{i}_{r}`` for each repeat of a repeated row;
    parameter-free rows (Upsample, Concat, pools) are not modules there
    and are left out.  Feature maps come back NHWC in NumPy, the Detect
    head's list as is."""
    import torch

    feats, hooks = {}, []

    def keep(name):
        def hook(mod, inp, out):
            feats[name] = (out.detach().permute(0, 2, 3, 1).float().cpu()
                           .numpy() if isinstance(out, torch.Tensor)
                           else out)
        return hook

    for i, m in enumerate(model.model):
        if isinstance(m, torch.nn.Sequential):
            hooks += [c.register_forward_hook(keep(f"l{i}_{r}"))
                      for r, c in enumerate(m)]
        elif any(True for _ in m.parameters()):
            hooks.append(m.register_forward_hook(keep(f"l{i}")))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return feats


def feature_visualization(features, save_dir: str, n: int = 32,
                          max_stages: Optional[int] = None) -> list:
    """Per-stage feature-map grids: for every 4-D NHWC map of
    ``features`` (``capture_features``' dict, in layer order), the first
    ``n`` channels of image 0 tiled 8 wide, saved as
    ``stage{k}_{name}_features.png`` beside a ``.npy`` of the map; heads
    (lists) are skipped."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    written = []
    for stage, name in enumerate(sorted(
            features,
            key=lambda k: (int(k[1:].split("_")[0])
                           if k[1:].split("_")[0].isdigit() else 1 << 30))):
        if max_stages is not None and len(written) >= max_stages:
            break
        out = features[name]
        if not hasattr(out, "ndim") or out.ndim != 4:
            continue
        x = np.asarray(out)
        _, h, w, c = x.shape
        if h <= 1 or w <= 1:
            continue
        k = min(n, c)
        ncols = 8
        nrows = int(math.ceil(k / ncols))
        fig, ax = plt.subplots(nrows, ncols, tight_layout=True,
                               squeeze=False)
        ax = ax.ravel()
        for i in range(k):
            ax[i].imshow(x[0, :, :, i], cmap="gray")
        for i in range(len(ax)):
            ax[i].axis("off")
        f = os.path.join(save_dir, f"stage{stage}_{name}_features.png")
        fig.savefig(f, dpi=150, bbox_inches="tight")
        plt.close(fig)
        np.save(os.path.splitext(f)[0] + ".npy", x[0])
        written.append(f)
    return written
