"""Metric plots (port of ``plot_mc_curve`` and ``plot_val_study`` from
``adaptiveisp_tpu/obs/plots.py``; the other plots come with the
observability slice).  matplotlib is imported when a plot is drawn."""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np


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
