"""Metric plots (port of ``plot_mc_curve`` from
``adaptiveisp_tpu/obs/plots.py``; the other plots come with the
observability slice).  matplotlib is imported when a plot is drawn."""

from __future__ import annotations

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
