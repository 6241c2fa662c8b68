"""Detection metrics: mAP and the confusion matrix, host-side NumPy (port
of ``adaptiveisp_tpu/detect/metrics.py``, formula for formula).

The protocol is the reference's and must stay numerically identical: the
101-point interpolated AP over the monotone precision envelope, the
descending-confidence ``np.interp`` sampling onto a 1000-point grid, and
the greedy unique-match rule of ``process_batch``.  They run on the host
after the device's NMS; the PR-curve arithmetic over a validation set is
cheap next to the detector.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from adaptiveisp_tpu_torch.detect.boxes import box_iou_np


# np.trapz became np.trapezoid in NumPy 2.0 (same arithmetic)
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def fitness(x: np.ndarray) -> np.ndarray:
    """0.1*mAP50 + 0.9*mAP (reference metrics.py:17-20)."""
    w = np.array([0.0, 0.0, 0.1, 0.9])
    return (x[:, :4] * w).sum(1)


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate(([y[0]] * (nf // 2), y, [y[-1]] * (nf // 2)), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall, precision):
    """101-point COCO-interpolated AP (protocol: reference metrics.py:98-123).

    Extends the curve with (r=0, p=1) / (r=1, p=0) sentinels, replaces the
    precision curve with its right-to-left running-max envelope, then
    integrates the envelope sampled on the fixed 101-point recall grid.
    """
    r_curve = np.concatenate(([0.0], recall, [1.0]))
    envelope = np.concatenate(([1.0], precision, [0.0]))[::-1]
    envelope = np.maximum.accumulate(envelope)[::-1]
    grid = np.linspace(0, 1, 101)
    ap = _trapezoid(np.interp(grid, r_curve, envelope), grid)
    return ap, envelope, r_curve


# fixed confidence grid the per-class P/R curves are sampled onto; conf is
# descending after the global sort, hence the negated-x interp below
_CONF_GRID = np.linspace(0, 1, 1000)


def _class_curves(tp_c, conf_c, n_labels, eps):
    """P/R-vs-confidence curves + per-IoU AP for one class.

    tp_c [n, n_iou] is confidence-sorted (descending).  Returns the recall
    and precision curves sampled on _CONF_GRID (using the lowest-IoU column,
    i.e. IoU 0.5, as the protocol does), AP at every IoU threshold, and the
    IoU-0.5 precision envelope sampled on the recall grid (PR-curve plot).
    """
    cum_tp = tp_c.cumsum(0)
    cum_fp = (1 - tp_c).cumsum(0)
    recall = cum_tp / (n_labels + eps)
    precision = cum_tp / (cum_tp + cum_fp)
    r_grid = np.interp(-_CONF_GRID, -conf_c, recall[:, 0], left=0)
    p_grid = np.interp(-_CONF_GRID, -conf_c, precision[:, 0], left=1)
    ap = np.zeros(tp_c.shape[1])
    pr = np.zeros_like(_CONF_GRID)
    for j in range(tp_c.shape[1]):
        ap[j], envelope, r_curve = compute_ap(recall[:, j], precision[:, j])
        if j == 0:
            pr = np.interp(_CONF_GRID, r_curve, envelope)
    return r_grid, p_grid, ap, pr


def ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16,
                 plot: bool = False, save_dir: str = ".", names=()):
    """Per-class AP from accumulated predictions (protocol: reference
    metrics.py:31-95).

    tp: [n_pred, n_iou] bool; conf, pred_cls: [n_pred]; target_cls: [n_gt].
    Returns (tp, fp, p, r, f1, ap[nc, n_iou], unique_classes).  The final
    scalar P/R/F1 are read off the confidence grid at the point maximizing
    the smoothed class-mean F1 curve.  With plot=True, dumps the PR curve
    and the F1/P/R-vs-confidence curves into save_dir (reference
    metrics.py:85-89).
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes, n_labels = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]
    n_grid = _CONF_GRID.shape[0]

    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, n_grid))
    r = np.zeros((nc, n_grid))
    pr_curves = []  # per-class precision sampled on the 1000-pt recall grid
    for ci, c in enumerate(unique_classes):
        mine = pred_cls == c
        if n_labels[ci] and mine.any():
            r[ci], p[ci], ap[ci], pr = _class_curves(
                tp[mine], conf[mine], n_labels[ci], eps)
            pr_curves.append(pr)
        else:
            pr_curves.append(np.zeros_like(_CONF_GRID))

    f1 = 2 * p * r / (p + r + eps)
    if plot:
        import os

        from adaptiveisp_tpu_torch.obs.plots import plot_mc_curve

        labels = [names.get(int(c), str(int(c))) if isinstance(names, dict)
                  else (names[int(c)] if len(names) > int(c) else str(int(c)))
                  for c in unique_classes]
        plot_pr_curve(_CONF_GRID, pr_curves, ap,
                      os.path.join(save_dir, "PR_curve.png"), labels)
        plot_mc_curve(_CONF_GRID, f1, os.path.join(save_dir, "F1_curve.png"),
                      labels, ylabel="F1")
        plot_mc_curve(_CONF_GRID, p, os.path.join(save_dir, "P_curve.png"),
                      labels, ylabel="Precision")
        plot_mc_curve(_CONF_GRID, r, os.path.join(save_dir, "R_curve.png"),
                      labels, ylabel="Recall")
    best = smooth(f1.mean(0), 0.1).argmax()
    p, r, f1 = p[:, best], r[:, best], f1[:, best]
    tp_count = (r * n_labels).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return tp_count, fp_count, p, r, f1, ap, unique_classes.astype(int)


def correct_from_iou(iou: np.ndarray, correct_class: np.ndarray,
                     iouv: np.ndarray) -> np.ndarray:
    """Greedy unique matching at each IoU threshold given a precomputed
    label-x-detection IoU matrix (the matching rule of
    val_adaptiveisp.py:79-101) — shared by box mAP (box IoU) and mask mAP
    (mask IoU)."""
    correct = np.zeros((iou.shape[1], iouv.shape[0]), bool)
    for i in range(len(iouv)):
        li, di = np.where((iou >= iouv[i]) & correct_class)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if li.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def process_batch(detections: np.ndarray, labels: np.ndarray,
                  iouv: np.ndarray) -> np.ndarray:
    """Correct-prediction matrix at 10 IoU thresholds
    (reference val_adaptiveisp.py:79-101).

    detections: [N, 6] (xyxy, conf, cls); labels: [M, 5] (cls, xyxy).
    Returns bool [N, len(iouv)].
    """
    if detections.shape[0] == 0 or labels.shape[0] == 0:
        return np.zeros((detections.shape[0], iouv.shape[0]), bool)
    iou = box_iou_np(labels[:, 1:], detections[:, :4])
    correct_class = labels[:, 0:1] == detections[:, 5]
    return correct_from_iou(iou, correct_class, iouv)


class ConfusionMatrix:
    """(nc+1)x(nc+1) detection confusion matrix (reference metrics.py:126-219)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections, labels):
        if detections is None or detections.shape[0] == 0:
            if labels.shape[0]:
                for gc in labels[:, 0].astype(int):
                    self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        if labels.shape[0] == 0:
            for dc in det_classes:
                self.matrix[dc, self.nc] += 1
            return
        iou = box_iou_np(labels[:, 1:], detections[:, :4])
        li, di = np.where(iou > self.iou_thres)
        if li.shape[0]:
            matches = np.stack([li, di, iou[li, di]], axis=1)
            if li.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j]][0], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1
        if n:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1

    def tp_fp(self):
        tp = self.matrix.diagonal()
        fp = self.matrix.sum(1) - tp
        return tp[:-1], fp[:-1]

    def plot(self, normalize: bool = True, save_dir: str = ".", names=()):
        """Heatmap of the matrix, columns normalized by true-class count
        (reference metrics.py:187-215; matplotlib imshow, no seaborn)."""
        import os

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        array = self.matrix / (
            (self.matrix.sum(0).reshape(1, -1) + 1e-9) if normalize else 1)
        fig, ax = plt.subplots(1, 1, figsize=(12, 9), tight_layout=True)
        im = ax.imshow(array, cmap="Blues", vmin=0.0)
        fig.colorbar(im, ax=ax)
        n = self.nc + 1
        use_names = 0 < len(names) < 99 and len(names) == self.nc
        ticklabels = (list(names) + ["background"]) if use_names \
            else [str(i) for i in range(n)]
        ax.set_xticks(range(n))
        ax.set_yticks(range(n))
        ax.set_xticklabels(ticklabels, rotation=90, fontsize=8)
        ax.set_yticklabels(ticklabels, fontsize=8)
        if self.nc < 30:  # annotate cells
            for i in range(n):
                for j in range(n):
                    v = array[i, j]
                    if v >= 0.005:
                        ax.text(j, i, f"{v:.2f}", ha="center", va="center",
                                fontsize=8,
                                color="white" if v > 0.5 * np.nanmax(array)
                                else "black")
        ax.set_xlabel("True")
        ax.set_ylabel("Predicted")
        ax.set_title("Confusion Matrix")
        out = os.path.join(save_dir, "confusion_matrix.png")
        fig.savefig(out, dpi=250)
        plt.close(fig)
        return out


def plot_pr_curve(px, py, ap, save_path: str, names=()):
    """PR-curve plot at mAP@0.5 (reference metrics.py:85-89 / plot_pr_curve)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if len(py) else np.zeros((len(px), 0))
    for i in range(py.shape[1]):
        label = (f"{names[i]} {ap[i, 0]:.3f}" if i < len(names)
                 else f"class {i}")
        ax.plot(px, py[:, i], linewidth=1, label=label)
    if py.shape[1]:
        ax.plot(px, py.mean(1), linewidth=3, color="blue",
                label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(fontsize="small")
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def summarize(stats, names=None, plot_dir=None) -> Dict[str, float]:
    """mp/mr/map50/map from accumulated (correct, conf, pcls, tcls) tuples.

    With ``names`` (id -> name), also returns ``per_class``: one row per
    class with (name, n_labels, P, R, AP50, AP) — the reference's verbose
    per-class table (val_adaptiveisp.py:406-408).  With ``plot_dir``, the
    PR/F1/P/R curve plots are written there."""
    stats = [np.concatenate(x, 0) for x in zip(*stats)]
    if len(stats) and stats[0].any():
        _, _, p, r, f1, ap, classes = ap_per_class(
            *stats, plot=plot_dir is not None,
            save_dir=plot_dir or ".", names=names or ())
        ap50, ap_mean = ap[:, 0], ap.mean(1)
        out = {
            "precision": float(p.mean()),
            "recall": float(r.mean()),
            "map50": float(ap50.mean()),
            "map": float(ap_mean.mean()),
            # per-class-id AP (the reference's `maps` vector feeding
            # --image-weights, train.py:259/275-278)
            "class_ap": {int(c): float(ap_mean[i])
                         for i, c in enumerate(classes)},
        }
        if names is not None:
            nt = np.bincount(stats[3].astype(int),
                             minlength=int(max(classes, default=0)) + 1)
            out["per_class"] = [
                {"class": names.get(int(c), str(int(c))),
                 "labels": int(nt[int(c)]),
                 "precision": float(p[i]), "recall": float(r[i]),
                 "map50": float(ap50[i]), "map": float(ap_mean[i])}
                for i, c in enumerate(classes)]
        return out
    return {"precision": 0.0, "recall": 0.0, "map50": 0.0, "map": 0.0,
            **({"per_class": []} if names is not None else {})}
